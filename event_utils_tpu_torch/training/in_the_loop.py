"""Training in the loop: the simulator feeding the trainers directly (port
of ``event_utils_tpu.training.in_the_loop``).

Every step renders fresh random scenes, runs the sensor model on the card
(``simulation.esim.simulate_events_device_batch``), voxelizes and takes
one optimiser step: no intermediate files.

Scene draws. JAX draws each scene from a threefry key; here each element's
texture, velocity ``v``, ``(omega, s)``, age and fresh/steady choice come
from a CPU ``torch.Generator`` seeded by (run seed, step, element)
(``draw_scenes``), and the scene is then moved to the device, so one seed
gives the same scenes on the card and on the CPU. Training batches agree
with JAX's in distribution only. The pinned held-out eval batches behind
the committed weights are rebuilt exactly from their scene parameters,
carried over as data (``load_scenes`` and ``FLOW_EVAL_SCENES`` /
``RECON_EVAL_SCENES``, written by ``scripts/make_train_eval_scenes.py``).

Frames are rendered at the stamps ``jnp.linspace`` gives in float32
(``jax_linspace``), with the order-1 wrap sampler of the simulator
(``esim._sample_wrap``: JAX's ``index % size``). The B scenes of a batch
go through one batched render, one crossing scan over the frame pairs and
one compaction with a cut per scene, as JAX's ``jax.vmap`` over the
scenes; each scene's events are bit for bit those of its own simulation.
A flow batch's grids take one batched voxel kernel launch under
``set_default_impl('pallas')`` (``voxelize_batch``); an E2VID batch's
windows one pair of flat scatters
(``representations.events_to_neg_pos_voxel_segments``), each window's
first and last stamp read off the sorted rows (``window_stamps``).

Under a trainer's mesh, rank r simulates only the elements ``[r B/N,
(r+1) B/N)`` of each step, each from its own ``(seed, step, element)``
draws, so the global batch holds the same scenes, bit for bit, as a run
in one process; the eval batches are sharded alike, and the logged and
returned numbers (losses, evals, event counts) are the global batch's.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..errors import ConfigurationError
from ..parallel import sharding
from ..ops.scatter import get_default_impl
from ..representations.voxel_grid import (
    events_to_neg_pos_voxel_segments, events_to_voxel_rows)
from ..simulation.esim import (SimulatorConfig, _sample_wrap,
                               simulate_events_device_batch, smooth_texture)

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the pinned --eval_seed 0 batches of runs/flow128_similarity (stage 9) and
# runs/recon128v2 (stage 8), with JAX's numbers on them in eval_anchors.json
FLOW_EVAL_SCENES = os.path.join(DATA_DIR, "flow_eval_scenes.npz")
RECON_EVAL_SCENES = os.path.join(DATA_DIR, "recon_eval_scenes.npz")
EVAL_ANCHORS = os.path.join(DATA_DIR, "eval_anchors.json")


def jax_linspace(stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(0.0, stop, num)`` in float32, as XLA computes it on
    the CPU: its simplifier turns ``stop * (i / (num - 1))`` into ``i *
    (stop * (1 / (num - 1)))``, each product rounded to f32; the last
    stamp is ``stop`` itself."""
    f32 = np.float32
    step = f32(stop) * (f32(1.0) / f32(num - 1))
    out = np.arange(num - 1, dtype=f32) * step
    return np.append(out, f32(stop)).astype(f32)


def _render_translating(texture, v, t):
    """Frames ``(F, H, W)`` of ``texture`` translating at ``v`` px/s at the
    times ``t`` (F,)."""
    return _render_similarity(texture, v, 0.0, 0.0, t)


def _render_similarity(texture, v, omega, s, t, age=0.0):
    """Frames ``(F, H, W)`` of the similarity motion at times ``t`` (F,):
    translation ``v`` px/s, rotation ``omega`` rad/s and divergence ``s``
    1/s about the sensor centre. ``age`` shifts the rotation/scale clock
    only (angle ``omega (t+age)``, scale ``e^{s (t+age)}``); translation
    stays on ``t``. JAX's ``_render_similarity``, per frame. Scenes with
    leading axes render in one pass: ``texture (..., H, W)``, ``v (...,
    2)`` and ``omega``, ``s``, ``age`` of shape ``(...)`` (or scalars)
    give ``(..., F, H, W)``, each scene's frames as its own render."""
    H, W = texture.shape[-2:]
    dev = texture.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)[:, None, None]

    def per_scene(a):   # (...) -> (..., 1, 1, 1), against (F, H, W)
        return torch.as_tensor(a, dtype=torch.float32,
                               device=dev)[..., None, None, None]

    v = torch.as_tensor(v, dtype=torch.float32, device=dev)
    vx, vy = per_scene(v[..., 0]), per_scene(v[..., 1])
    omega, s, age = per_scene(omega), per_scene(s), per_scene(age)
    # the pixel's texture coordinate at t=0: undo the translation, then
    # the rotation, then the exponential scaling
    x0 = xx - cx - vx * t
    y0 = yy - cy - vy * t
    t_rs = t + age
    c, sn = torch.cos(omega * t_rs), torch.sin(omega * t_rs)
    xr = c * x0 + sn * y0
    yr = -sn * x0 + c * y0
    f = torch.exp(-s * t_rs)
    return _sample_wrap(texture, cy + yr * f, cx + xr * f)


# ---------------------------------------------------------------------------
# Scene parameters
# ---------------------------------------------------------------------------

def _scene_generator(seed: int, step: int, element: int) -> torch.Generator:
    """The CPU generator of one scene: splitmix64 of (seed, step, element)."""
    mask = (1 << 64) - 1
    z = 0
    for part in (seed, step, element):
        z = (z + (part & mask) + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        z ^= z >> 31
    return torch.Generator(device="cpu").manual_seed(z & ((1 << 63) - 1))


def draw_scenes(seed: int, step: int, batch_size: int,
                sensor_size: Tuple[int, int], v_max: float = 40.0,
                octaves: int = 3, omega_max: float = 0.0, s_max: float = 0.0,
                age_max: float = 0.0, fresh_prob: float = 0.0,
                elements: Optional[range] = None) -> dict:
    """Scene parameters of one batch (of the ``elements`` of a batch of
    ``batch_size``, all by default), drawn on the CPU: ``texture`` (B, H,
    W) from ``smooth_texture``, ``v`` (B, 2) uniform in ``[-v_max,
    v_max]``, ``ws`` (B, 2) = ``(omega, s)`` uniform in ``[-omega_max,
    omega_max] x [-s_max, s_max]`` (zeros for pure translation), ``age``
    (B,) uniform in ``[0, age_max]`` and ``fresh`` (B,) bool with
    probability ``fresh_prob``; ``similarity`` says whether the motion
    family is wider than translation."""
    similarity = bool(omega_max or s_max)
    caps = torch.tensor([omega_max, s_max], dtype=torch.float32)
    out = {k: [] for k in ("texture", "v", "ws", "age", "fresh")}
    for b in range(batch_size) if elements is None else elements:
        g = _scene_generator(seed, step, b)
        out["texture"].append(smooth_texture(g, sensor_size, octaves=octaves,
                                             device="cpu"))
        out["v"].append((torch.rand(2, generator=g) * 2 - 1) * v_max)
        out["ws"].append((torch.rand(2, generator=g) * 2 - 1) * caps
                         if similarity else torch.zeros(2))
        out["age"].append(torch.rand((), generator=g) * age_max
                          if age_max else torch.zeros(()))
        out["fresh"].append(torch.rand((), generator=g) < fresh_prob
                            if fresh_prob else torch.tensor(False))
    scenes = {k: torch.stack(v) for k, v in out.items()}
    scenes["similarity"] = similarity
    return scenes


def load_scenes(path: str) -> dict:
    """Scene parameters from an ``.npz`` of ``texture`` (B, H, W), ``v``
    (B, 2) and ``ws`` (B, 2), at age 0 and steady (``FLOW_EVAL_SCENES``,
    ``RECON_EVAL_SCENES``)."""
    with np.load(path) as z:
        scenes = {k: torch.as_tensor(np.asarray(z[k], np.float32))
                  for k in ("texture", "v", "ws")}
    B = scenes["v"].shape[0]
    if scenes["texture"].dim() != 3 or scenes["texture"].shape[0] != B \
            or scenes["ws"].shape != (B, 2) or scenes["v"].shape != (B, 2):
        raise ConfigurationError(f"{path}: need texture (B, H, W), v and ws "
                                 "(B, 2)")
    scenes["age"] = torch.zeros(B)
    scenes["fresh"] = torch.zeros(B, dtype=torch.bool)
    scenes["similarity"] = bool(scenes["ws"].any())
    return scenes


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def simulate_flow_scenes(scenes: dict, capacity: int, window_t: float = 0.1,
                         num_frames: int = 9, c_pos: float = 0.15,
                         c_neg: float = 0.15, burn_in: int = 0,
                         return_saturation: bool = False, device=None):
    """One supervised flow batch from explicit scene parameters.

    Per scene: ``burn_in * (num_frames - 1) + num_frames`` frames over
    ``(burn_in + 1) * window_t`` seconds, simulated into a
    ``capacity``-padded batch (the earliest events when more fire); all B
    scenes in one batched render and one batched simulation. With
    ``burn_in`` the mask keeps only the last window (steady state), or the
    first for scenes drawn ``fresh``.

    Returns ``(events (B, capacity, 4), mask (B, capacity), gt)`` on the
    device: ``gt`` is ``v`` (B, 2) for pure translation, else the dense
    field ``v + (omega J + s)(p - c - v t)`` (B, 2, H, W) at the kept
    window's start ``t``. ``return_saturation`` adds (B,) bools: the
    scene's stream overflowed ``capacity``."""
    dev = resolve_device(device)
    tex = scenes["texture"].to(dev)
    B, H, W = tex.shape
    v, ws = scenes["v"].to(dev), scenes["ws"].to(dev)
    cfg = SimulatorConfig(c_pos=c_pos, c_neg=c_neg)
    fts = jax_linspace((burn_in + 1) * window_t,
                       burn_in * (num_frames - 1) + num_frames)
    frames = _render_similarity(tex, v, ws[:, 0], ws[:, 1], fts,
                                age=scenes["age"].to(dev))
    ev, mask, overflow = simulate_events_device_batch(frames, fts, capacity,
                                                      cfg)
    t_ref = torch.zeros(B, device=dev)    # the kept window's start
    if burn_in:
        fresh = scenes["fresh"].to(dev)
        keep = torch.where(fresh[:, None], ev[..., 2] < window_t,
                           ev[..., 2] >= burn_in * window_t)
        t_ref = torch.where(fresh, 0.0, np.float32(burn_in * window_t))
        mask = mask * keep.to(mask.dtype)
    if scenes["similarity"]:
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        yy, xx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev) - cy,
            torch.arange(W, dtype=torch.float32, device=dev) - cx,
            indexing="ij")
        rx = xx - (v[:, 0] * t_ref)[:, None, None]
        ry = yy - (v[:, 1] * t_ref)[:, None, None]
        w0, w1 = ws[:, 0, None, None], ws[:, 1, None, None]
        gt = torch.stack([v[:, 0, None, None] - w0 * ry + w1 * rx,
                          v[:, 1, None, None] + w0 * rx + w1 * ry], 1)
    else:
        gt = v
    out = (ev, mask, gt)
    return out + (overflow > 0,) if return_saturation else out


def simulate_flow_batch(seed: int, step: int, batch_size: int,
                        sensor_size: Tuple[int, int], capacity: int,
                        v_max: float = 40.0, window_t: float = 0.1,
                        num_frames: int = 9, octaves: int = 3,
                        c_pos: float = 0.15, c_neg: float = 0.15,
                        omega_max: float = 0.0, s_max: float = 0.0,
                        return_saturation: bool = False, burn_in: int = 0,
                        fresh_prob: float = 0.0, age_max: float = 0.0,
                        elements: Optional[range] = None, device=None):
    """One fresh supervised flow batch: ``draw_scenes(seed, step, ...)``
    then ``simulate_flow_scenes`` (of ``elements`` only, when given).
    ``fresh_prob`` needs ``burn_in``; see JAX's ``simulate_flow_batch`` for
    the diet each option gives."""
    scenes = draw_scenes(seed, step, batch_size, sensor_size, v_max=v_max,
                         octaves=octaves, omega_max=omega_max, s_max=s_max,
                         age_max=age_max,
                         fresh_prob=fresh_prob if burn_in else 0.0,
                         elements=elements)
    return simulate_flow_scenes(scenes, capacity, window_t=window_t,
                                num_frames=num_frames, c_pos=c_pos,
                                c_neg=c_neg, burn_in=burn_in,
                                return_saturation=return_saturation,
                                device=device)


def voxelize_batch(events, mask, num_bins: int, sensor_size,
                   combined: bool = False) -> torch.Tensor:
    """``(B, C, H, W)`` voxel grids of padded events ``(B, N, 4)``: per
    element what ``events_to_neg_pos_voxel`` (or ``events_to_voxel`` when
    ``combined``) gives on its masked events, as JAX's ``jax.vmap`` over the
    rows (``training/loop.py:174-185``): each row's window is its masked
    first and last stamp, one reduction over all rows. Under
    ``set_default_impl('pallas')`` one batched voxel kernel launch
    (``voxel_scatter_batched``, both polarities at once); under 'xla' one
    ``index_add_`` with ids offset by row."""
    x, y, t, p = (a.contiguous() for a in events.unbind(-1))
    impl = "matmul" if get_default_impl() == "pallas" else None
    return events_to_voxel_rows(x, y, t, p, num_bins, sensor_size, mask=mask,
                                split=not combined, impl=impl)


def window_stamps(ts, mask, bounds):
    """The first and last stamp of each window ``(bounds[w], bounds[w+1]]``
    of each row, ``(B, T)`` each, read off the rows' order: ``ts (B, N)``
    time-sorted end to end with the valid events first (``mask (B, N)``), as
    ``simulate_events_device_batch`` gives them (its pads carry the row's
    last valid stamp). Window w's events are the slots from the first stamp
    past ``bounds[w]`` to the last at or before ``bounds[w+1]``, cut at the
    valid count; an empty window gets float32 max and -max, the values
    ``segment_windows`` gives it."""
    B = ts.shape[0]
    edges = bounds.reshape(1, -1).expand(B, -1).contiguous()
    cut = torch.searchsorted(ts.contiguous(), edges, right=True)
    count = (mask != 0).sum(1, keepdim=True)
    lo, hi = cut[:, :-1], torch.minimum(cut[:, 1:], count)
    some = hi > lo
    big = torch.finfo(torch.float32).max
    first = ts.gather(1, torch.where(some, lo, 0))
    last = ts.gather(1, torch.where(some, hi - 1, 0))
    return torch.where(some, first, big), torch.where(some, last, -big)


def simulate_recon_scenes(scenes: dict, capacity: int, seq_len: int,
                          window_t: float = 0.05,
                          sim_steps_per_window: int = 4, num_bins: int = 5,
                          combined: bool = False, c_pos: float = 0.15,
                          c_neg: float = 0.15,
                          return_saturation: bool = False, device=None):
    """One supervised E2VID sequence batch from explicit scene parameters.

    Per scene: ``seq_len * sim_steps_per_window + 1`` frames over ``seq_len
    * window_t`` seconds (the sensor state threads across the whole
    sequence), all B scenes in one batched render and one batched
    simulation; then each window ``(t_w, t_{w+1}]`` is voxelized over its
    own events: every window of every scene in one pair of flat scatters
    (ids offset by window and element), each window's first and last stamp
    read off its scene's sorted row (``window_stamps``).

    Returns ``(voxels (T, B, C, H, W), frames (T, B, 1, H, W))`` on the
    device, ``frames[w]`` the rendered frame at window w's end;
    ``capacity`` bounds events per sequence. ``return_saturation`` adds
    (B,) bools: the scene's stream overflowed ``capacity``."""
    dev = resolve_device(device)
    tex = scenes["texture"].to(dev)
    B, H, W = tex.shape
    ws = scenes["ws"].to(dev)
    cfg = SimulatorConfig(c_pos=c_pos, c_neg=c_neg)
    spw = sim_steps_per_window
    fts = jax_linspace(seq_len * window_t, seq_len * spw + 1)
    bounds = torch.as_tensor(fts, device=dev)[::spw].contiguous()  # edges
    target_idx = torch.arange(1, seq_len + 1, device=dev) * spw
    frames = _render_similarity(tex, scenes["v"].to(dev), ws[:, 0], ws[:, 1],
                                fts)
    ev, mask, overflow = simulate_events_device_batch(frames, fts, capacity,
                                                      cfg)
    # window w holds the events with t_w < t <= t_{w+1}; its first and last
    # stamps are read off each row's order (segment w * B + b)
    t_rows = ev[..., 2].contiguous()
    w = torch.searchsorted(bounds, t_rows) - 1
    seg = torch.where((mask > 0) & (w >= 0) & (w < seq_len),
                      w * B + torch.arange(B, device=dev)[:, None], -1)
    t0, t1 = (a.t().reshape(-1) for a in window_stamps(t_rows, mask, bounds))
    x, y, ts, p = ev.reshape(-1, 4).unbind(-1)
    voxels = events_to_neg_pos_voxel_segments(
        x, y, ts, p, seg.reshape(-1), seq_len * B, num_bins, (H, W),
        combined=combined, t0=t0, t1=t1)
    out = (voxels.view((seq_len, B) + voxels.shape[1:]),
           frames.transpose(0, 1)[target_idx][:, :, None])
    return out + (overflow > 0,) if return_saturation else out


def simulate_recon_batch(seed: int, step: int, batch_size: int,
                         sensor_size: Tuple[int, int], capacity: int,
                         seq_len: int, v_max: float = 40.0,
                         window_t: float = 0.05,
                         sim_steps_per_window: int = 4, num_bins: int = 5,
                         combined: bool = False, octaves: int = 3,
                         c_pos: float = 0.15, c_neg: float = 0.15,
                         omega_max: float = 0.0, s_max: float = 0.0,
                         return_saturation: bool = False,
                         elements: Optional[range] = None, device=None):
    """One fresh E2VID sequence batch: ``draw_scenes(seed, step, ...)``
    then ``simulate_recon_scenes`` (of ``elements`` only, when given)."""
    scenes = draw_scenes(seed, step, batch_size, sensor_size, v_max=v_max,
                         octaves=octaves, omega_max=omega_max, s_max=s_max,
                         elements=elements)
    return simulate_recon_scenes(
        scenes, capacity, seq_len, window_t=window_t,
        sim_steps_per_window=sim_steps_per_window, num_bins=num_bins,
        combined=combined, c_pos=c_pos, c_neg=c_neg,
        return_saturation=return_saturation, device=device)


# ---------------------------------------------------------------------------
# Evals
# ---------------------------------------------------------------------------

def dense_gt(gt, sensor_size) -> torch.Tensor:
    """A (B, 2) uniform velocity broadcast to (B, 2, H, W); a dense field
    unchanged."""
    if gt.dim() == 2:
        return gt[:, :, None, None].expand((gt.shape[0], 2)
                                           + tuple(sensor_size))
    return gt


def _mesh(trainer):
    return getattr(trainer, "mesh", None)


def _elements(trainer, batch_size: int) -> range:
    """The elements of a ``batch_size`` batch this rank simulates (all of
    them without a mesh)."""
    sl = sharding.shard_slice(_mesh(trainer), batch_size)
    return range(sl.start, sl.stop)


def _shard_scenes(trainer, scenes: dict) -> dict:
    """This rank's scenes of a ``draw_scenes`` / ``load_scenes`` dict."""
    sl = sharding.shard_slice(_mesh(trainer), scenes["v"].shape[0])
    return {k: v if k == "similarity" else v[sl] for k, v in scenes.items()}


def _over_mesh(trainer, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the trainer's mesh (itself without one)."""
    return sharding.all_reduce(t.detach().clone(), _mesh(trainer), op)


def _logger(trainer, log_fn):
    """``log_fn`` on the rank that logs, a no-op on the others."""
    return log_fn if sharding.is_writer(_mesh(trainer)) else (lambda s: None)


def flow_eval(trainer, voxel, gt) -> Tuple[float, float]:
    """Held-out ``(AEE, zero-flow AEE)`` in px/s of ``trainer``'s flow on a
    voxel batch against its ground truth (under a mesh: this rank's shard
    of the batch, the means taken over the whole batch)."""
    with torch.no_grad():
        flow = trainer.predict(voxel)
        aee = torch.linalg.vector_norm(flow - dense_gt(gt, flow.shape[-2:]),
                                       dim=1).mean()
        zero = torch.linalg.vector_norm(gt, dim=1).mean()
        aee, zero = (_over_mesh(trainer, v, "mean") for v in (aee, zero))
    return float(aee), float(zero)


def recon_eval(trainer, voxels, frames) -> Tuple[float, float, float, float]:
    """Held-out PSNR (dB) and SSIM of ``trainer.reconstruct`` on a ``(T, B,
    C, H, W)`` sequence against its frames: over all windows, then over the
    steady windows ``t >= max(burn_in, T // 2)``, where the state has
    history. Each window's value is the mean over the batch (under a
    mesh: over every rank's shard)."""
    from ..utils.metrics import psnr, ssim

    imgs, _ = trainer.reconstruct(voxels)
    imgs = imgs.cpu().numpy()
    frames = frames.cpu().numpy()
    T, B = imgs.shape[:2]
    per_p = np.array([np.mean([float(psnr(imgs[t, b, 0], frames[t, b, 0]))
                               for b in range(B)]) for t in range(T)])
    per_s = np.array([np.mean([float(ssim(imgs[t, b, 0], frames[t, b, 0]))
                               for b in range(B)]) for t in range(T)])
    if _mesh(trainer) is not None:   # the batch's mean over the ranks
        per_p, per_s = _over_mesh(trainer, torch.as_tensor(
            np.stack([per_p, per_s]), device=trainer.device),
            "mean").cpu().numpy()
    t0 = max(int(getattr(trainer, "burn_in", 0)), T // 2)
    return (float(per_p.mean()), float(per_s.mean()),
            float(per_p[t0:].mean()), float(per_s[t0:].mean()))


def _saturation_warning(n_sat, n_elems, capacity, what):
    return (f"WARNING: {n_sat}/{n_elems} simulated scenes overflowed the "
            f"{capacity}-event capacity — their streams are TAIL-CUT in "
            f"time ({what}); raise capacity")


# ---------------------------------------------------------------------------
# Loops
# ---------------------------------------------------------------------------

def train_reconstruction_in_the_loop(trainer, steps: int,
                                     batch_size: int = 4, seq_len: int = 6,
                                     capacity: int = 65536,
                                     v_max: float = 40.0,
                                     window_t: float = 0.05,
                                     sim_steps_per_window: int = 4,
                                     omega_max: float = 0.0,
                                     s_max: float = 0.0,
                                     carry_segments: int = 1,
                                     seed: int = 0,
                                     eval_seed: Optional[int] = None,
                                     log_every: int = 20,
                                     eval_every: int = 100,
                                     ckpt_dir: Optional[str] = None,
                                     ckpt_every: int = 500, log_fn=print,
                                     on_eval=None, eval_scenes=None,
                                     stats: Optional[dict] = None):
    """Drive ``ReconstructionTrainer`` on simulated sequences.

    Every ``carry_segments`` steps one batch of ``batch_size`` scenes is
    simulated over ``carry_segments * seq_len`` windows and consumed as
    that many truncated-BPTT steps: the first from zero state (with the
    trainer's burn-in), the rest warm-started from the previous segment's
    final state on the same scenes. Every ``eval_every`` steps the net is
    scored on a held-out batch (``recon_eval``), drawn from ``eval_seed``
    (default ``seed``) at step -1, or rebuilt from ``eval_scenes`` (a path
    or ``load_scenes`` dict) when given.

    Returns ``(losses, psnr_curve)``, ``psnr_curve`` a list of ``(step,
    psnr_db, ssim, psnr_steady_db, ssim_steady)``. ``on_eval(losses,
    psnr_curve)`` is called after every eval point. ``stats``, when a
    dict, receives ``steps``, ``wall_s`` (synchronised), ``sim_s`` (host
    wall inside the simulator, synchronised) and ``events`` (the events
    in the training windows: the sum of the polarity-split grids, where
    each event weighs 1).
    """
    H, W = trainer.sensor_size
    dev = trainer.device
    log_fn = _logger(trainer, log_fn)
    carry_segments = max(int(carry_segments), 1)
    T = seq_len * carry_segments
    elements = _elements(trainer, batch_size)
    kw = dict(sim_steps_per_window=sim_steps_per_window,
              num_bins=trainer.num_bins, combined=trainer.combined_channels,
              return_saturation=True, device=dev)

    def gen(s):
        return simulate_recon_batch(
            seed, s, batch_size, (H, W), capacity, T, v_max=v_max,
            window_t=window_t, omega_max=omega_max, s_max=s_max,
            elements=elements, **kw)

    if eval_every:
        if eval_scenes is not None:
            scenes = (load_scenes(eval_scenes)
                      if isinstance(eval_scenes, str) else eval_scenes)
            eval_voxels, eval_frames, _ = simulate_recon_scenes(
                _shard_scenes(trainer, scenes), capacity, T,
                window_t=window_t, **kw)
        else:
            eval_voxels, eval_frames, _ = simulate_recon_batch(
                seed if eval_seed is None else eval_seed, -1, batch_size,
                (H, W), capacity, T, v_max=v_max, window_t=window_t,
                omega_max=omega_max, s_max=s_max, elements=elements, **kw)

    losses, psnr_curve, pending = [], [], []
    n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    n_elems, sat_warned = 0, False
    n_events = torch.zeros((), device=dev)
    sim_s = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        seg = i % carry_segments
        if seg == 0:
            ts = time.perf_counter()
            voxels, frames, sat = gen(i // carry_segments)
            if stats is not None:
                # every event of a window weighs 1 over its bins
                n_events = n_events + voxels.sum()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                sim_s += time.perf_counter() - ts
            n_sat = n_sat + sat.sum()
            n_elems += batch_size
        lo, hi = seg * seq_len, (seg + 1) * seq_len
        pending.append(trainer.train_sequence_async(
            voxels[lo:hi], frames[lo:hi],
            state0=None if seg == 0 else trainer.final_state, sharded=True))
        if log_every and (i + 1) % log_every == 0:
            losses.extend(float(x) for x in pending)
            pending = []
            sps = (i + 1) / (time.perf_counter() - t0)
            log_fn(f"step {trainer.step}: loss {losses[-1]:.5f} "
                   f"({sps:.2f} steps/s)")
            sat_all = int(_over_mesh(trainer, n_sat))
            if not sat_warned and sat_all > 0:
                sat_warned = True
                log_fn(_saturation_warning(
                    sat_all, n_elems, capacity,
                    "late windows under-populated vs full-window targets"))
        if eval_every and (i + 1) % eval_every == 0:
            p, s, p_ss, s_ss = recon_eval(trainer, eval_voxels, eval_frames)
            psnr_curve.append((trainer.step, p, s, p_ss, s_ss))
            log_fn(f"step {trainer.step}: held-out PSNR {p:.2f} dB, "
                   f"SSIM {s:.3f} (steady-state {p_ss:.2f} dB / "
                   f"{s_ss:.3f})")
            if on_eval is not None:
                on_eval(losses, psnr_curve)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            trainer.save_checkpoint(ckpt_dir)
    losses.extend(float(x) for x in pending)
    if stats is not None:
        stats.update(steps=steps, wall_s=time.perf_counter() - t0,
                     sim_s=sim_s, events=float(_over_mesh(trainer, n_events)))
    if ckpt_dir:
        trainer.save_checkpoint(ckpt_dir)
    return losses, psnr_curve


def train_flow_in_the_loop(trainer, steps: int, batch_size: int = 8,
                           capacity: int = 16384, v_max: float = 40.0,
                           window_t: float = 0.1, num_frames: int = 9,
                           omega_max: float = 0.0, s_max: float = 0.0,
                           burn_in: int = 0, fresh_prob: float = 0.0,
                           age_max: float = 0.0, seed: int = 0,
                           eval_seed: Optional[int] = None,
                           log_every: int = 20,
                           eval_every: int = 100,
                           ckpt_dir: Optional[str] = None,
                           ckpt_every: int = 500, log_fn=print,
                           on_eval=None, eval_scenes=None,
                           stats: Optional[dict] = None):
    """Drive ``FlowTrainer`` on simulated batches (no files).

    Each step: ``simulate_flow_batch(seed, step, ...)``, its grids
    (``voxelize_batch``), one optimiser step; losses are read only at log
    points. Every ``eval_every`` steps the net is scored on a held-out batch
    (``flow_eval``: AEE against the dense ground truth, and the zero-flow
    baseline), always drawn with ``fresh_prob = age_max = 0`` — from
    ``eval_seed`` (default ``seed``) at step -1, or rebuilt from
    ``eval_scenes`` (a path or ``load_scenes`` dict) when given.

    Returns ``(losses, aee_curve)``, ``aee_curve`` a list of ``(step,
    aee)``. ``on_eval(losses, aee_curve)`` is called after every eval
    point; ``stats`` as for ``train_reconstruction_in_the_loop`` (events:
    the kept events of the training batches).
    """
    H, W = trainer.sensor_size
    dev = trainer.device
    log_fn = _logger(trainer, log_fn)
    num_bins, combined = trainer.num_bins, trainer.combined_channels
    elements = _elements(trainer, batch_size)
    sim_kw = dict(window_t=window_t, num_frames=num_frames, burn_in=burn_in,
                  return_saturation=True, device=dev)

    def voxelize(ev, mask):
        return voxelize_batch(ev, mask, num_bins, (H, W), combined)

    if eval_every:
        if eval_scenes is not None:
            scenes = (load_scenes(eval_scenes)
                      if isinstance(eval_scenes, str) else eval_scenes)
            eval_ev, eval_mask, eval_gt, _ = simulate_flow_scenes(
                _shard_scenes(trainer, scenes), capacity, **sim_kw)
        else:
            eval_ev, eval_mask, eval_gt, _ = simulate_flow_batch(
                seed if eval_seed is None else eval_seed, -1, batch_size,
                (H, W), capacity, v_max=v_max, omega_max=omega_max,
                s_max=s_max, elements=elements, **sim_kw)
        eval_voxel = voxelize(eval_ev, eval_mask)

    losses, aee_curve, pending = [], [], []
    n_events = torch.zeros((), device=dev)
    n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    n_elems, sat_warned = 0, False
    sim_s = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        ev, mask, gt_v, sat = simulate_flow_batch(
            seed, i, batch_size, (H, W), capacity, v_max=v_max,
            omega_max=omega_max, s_max=s_max, fresh_prob=fresh_prob,
            age_max=age_max, elements=elements, **sim_kw)
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sim_s += time.perf_counter() - ts
        voxel = voxelize(ev, mask)
        pending.append(trainer.train_batch_async(
            voxel, ev, mask, dense_gt(gt_v, (H, W)), sharded=True))
        n_events = n_events + mask.sum()
        n_sat = n_sat + sat.sum()
        n_elems += batch_size
        if log_every and (i + 1) % log_every == 0:
            losses.extend(float(x) for x in pending)
            pending = []
            rate = float(_over_mesh(trainer, n_events)) / (
                time.perf_counter() - t0) / 1e6
            log_fn(f"step {trainer.step}: loss {losses[-1]:.5f}, "
                   f"{rate:.2f} Mev/s simulated+trained")
            sat_all = int(_over_mesh(trainer, n_sat))
            if not sat_warned and sat_all > 0:
                sat_warned = True
                log_fn(_saturation_warning(
                    sat_all, n_elems, capacity,
                    "late voxel bins under-populated vs full-window GT"))
        if eval_every and (i + 1) % eval_every == 0:
            aee, zero = flow_eval(trainer, eval_voxel, eval_gt)
            aee_curve.append((trainer.step, aee))
            log_fn(f"step {trainer.step}: held-out AEE {aee:.2f} px/s "
                   f"(zero-flow baseline {zero:.2f})")
            if on_eval is not None:
                on_eval(losses, aee_curve)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            trainer.save_checkpoint(ckpt_dir)
    losses.extend(float(x) for x in pending)
    if stats is not None:
        stats.update(steps=steps, wall_s=time.perf_counter() - t0,
                     sim_s=sim_s, events=float(_over_mesh(trainer, n_events)))
    if ckpt_dir:
        trainer.save_checkpoint(ckpt_dir)
    return losses, aee_curve
