"""ESIM-style event-camera simulator on the card (port of
``event_utils_tpu.simulation.esim``).

Generates event streams *with exact ground truth* (frames, dense flow,
motion parameters). Per pixel, the log intensity ``L = log(I + eps)`` is
tracked against a reference level ``L_ref``; whenever ``|L(t) - L_ref|``
crosses the contrast threshold ``C`` an event fires with the crossing's
sign, the timestamp linearly interpolated between the bracketing frames,
and ``L_ref`` moves to the crossed level. Sensor non-idealities: per-pixel
threshold mismatch (log-normal around ``c_pos``/``c_neg``), a refractory
period, additive log-intensity noise, and background activity (Poisson ON
"leak" events, random-polarity shot noise, stuck-ON hot pixels).

The scan is a loop over frame pairs of elementwise tensor operations on
``(B, H, W, K)``: every pixel of each of B scenes emits into ``K`` slots
per interval, masked by validity. The host stream (one scene) compacts
each chunk of ``cfg.chunk`` intervals with ``torch.nonzero`` (crossings in
``(step, y, x, k)`` order, then the chunk's noise events, as in JAX) and
sorts the whole stream by its float64 time with a stable sort, so ties
keep JAX's order. The device batch (``simulate_events_device_batch``, B
scenes in one frame loop, JAX's ``jax.vmap`` of ``simulate_events_device``)
sorts each scene's slots with one stable sort of the ``(B, slots)`` keys.

Randomness: where JAX takes a ``key`` this takes a ``torch.Generator``.
One 62-bit seed is drawn from it per call, and every noise draw comes from
a generator seeded by (that seed, the draw's purpose, the absolute frame
or interval index), so chunking does not change the stream. The draws
cannot reproduce threefry's bits: with noise options on, a stream agrees
with JAX's in distribution only. Without them the simulator is
deterministic, and a texture carried over from JAX (``load_texture``)
reproduces JAX's recordings up to float rounding of ``log``, ``exp``,
``sin`` and ``cos``.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_f32, pick_device, resolve_device
from ..errors import ConfigurationError

TEXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "textures")

# purposes of the seeded sub-streams (see module docstring)
_THRESH_POS, _THRESH_NEG, _FRAME_NOISE, _HOT, _NOISE_SLOTS = range(1, 6)


def _root_seed(generator: torch.Generator) -> int:
    """One seed for a run, drawn from ``generator`` (on its own device)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))


def _stream(root: int, purpose: int, index: int,
            device: torch.device) -> torch.Generator:
    """The generator of one purpose and one frame or interval index."""
    mask = (1 << 64) - 1
    z = (root + purpose * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9) \
        & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask  # splitmix64 finaliser
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    g = torch.Generator(device=device)
    g.manual_seed((z ^ (z >> 31)) & ((1 << 63) - 1))
    return g


# ---------------------------------------------------------------------------
# Scene synthesis: smooth textures + parametric camera/scene motions
# ---------------------------------------------------------------------------

def _resize_bilinear(grid: torch.Tensor, shape: Tuple[int, int]):
    """``jax.image.resize(grid, shape, "bilinear")`` for upsampling: the
    triangle kernel renormalised at the borders is a clamp of the source
    coordinate, which ``F.interpolate(align_corners=False)`` does."""
    return F.interpolate(grid[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0]


def smooth_texture(generator: torch.Generator, shape: Tuple[int, int],
                   octaves: int = 3, contrast: float = 0.9,
                   device=None) -> torch.Tensor:
    """Multi-octave smooth random intensity texture in ``[1-contrast, 1]``.

    Sums bilinearly upsampled random grids (period halving per octave),
    drawn from ``generator`` on its own device and moved to ``device``.
    The bits differ from JAX's threefry draws; carry a JAX texture over
    with :func:`load_texture` instead.
    """
    dev = resolve_device(device)
    H, W = shape
    acc = torch.zeros((H, W), dtype=torch.float32, device=dev)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, H // (2 ** (octaves - o + 1)))
        gw = max(2, W // (2 ** (octaves - o + 1)))
        grid = torch.rand((gh, gw), generator=generator,
                          device=generator.device).to(dev)
        acc = acc + amp * _resize_bilinear(grid, (H, W))
        total += amp
        amp *= 0.5
    acc = acc / total
    lo, hi = acc.min(), acc.max()
    unit = (acc - lo) / torch.clamp(hi - lo, min=1e-6)
    return (1.0 - contrast) + contrast * unit


def texture_path(seed: int, shape: Tuple[int, int] = (128, 128),
                 octaves: int = 3) -> str:
    """Path of a committed JAX texture (``scripts/make_sim_textures.py``)."""
    return os.path.join(TEXTURE_DIR,
                        f"seed{seed}_{shape[0]}x{shape[1]}_o{octaves}.npy")


def load_texture(path: str, shape: Optional[Tuple[int, int]] = None
                 ) -> np.ndarray:
    """A texture file: a 2-D float32 ``.npy`` of finite values in (0, 1],
    of ``shape`` when given; anything else raises ``ConfigurationError``."""
    tex = np.load(path, allow_pickle=False)
    if tex.ndim != 2 or tex.dtype != np.float32:
        raise ConfigurationError(
            f"texture {path}: need a 2-D float32 array, got {tex.dtype} "
            f"{tex.shape}")
    if shape is not None and tex.shape != tuple(shape):
        raise ConfigurationError(
            f"texture {path} is {tex.shape}, the sensor {tuple(shape)}")
    if not (np.isfinite(tex).all() and tex.min() > 0 and tex.max() <= 1):
        raise ConfigurationError(f"texture {path}: values outside (0, 1]")
    return tex


def _sample_wrap(tex: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """``jax.scipy.ndimage.map_coordinates(tex, [cy, cx], order=1,
    mode="wrap")``: taps ``floor`` and ``floor + 1`` taken modulo the size
    (period ``size``, not scipy's), weights ``1 - f`` and ``f``, the four
    products summed in JAX's order. A texture with leading axes ``(...,
    H, W)`` is sampled per leading index: ``cy`` and ``cx`` then start with
    the same axes (textures ``(B, H, W)``, coordinates ``(B, F, H, W)``),
    and each gathers from its own texture at an offset of ``b H W``."""
    H, W = tex.shape[-2:]
    flat = tex.reshape(-1)
    lead = tex.shape[:-2]
    base = 0
    if lead:
        base = (torch.arange(lead.numel(), device=tex.device) * (H * W)) \
            .reshape(lead + (1,) * (cy.dim() - len(lead)))
    taps = []
    for c, size in ((cy, H), (cx, W)):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.to(torch.int64)
        taps.append(((torch.remainder(i, size), 1 - upper_w),
                     (torch.remainder(i + 1, size), upper_w)))
    out = None
    for yi, wy in taps[0]:
        for xi, wx in taps[1]:
            term = (wy * wx) * flat[base + yi * W + xi]
            out = term if out is None else out + term
    return out


def _times(t, device) -> torch.Tensor:
    """Times as f32 on ``device``, shaped to broadcast against (H, W)."""
    t = torch.as_tensor(t, dtype=torch.float32).to(device)
    return t.reshape(t.shape + (1, 1))


@dataclass
class Scene:
    """A renderable moving scene: intensity frames + ground-truth flow.

    ``render(t) -> (..., H, W)`` intensity in (0, 1] and
    ``flow(t) -> (..., 2, H, W)`` the forward optic flow (u, v) in px/s,
    for a time or a 1-D batch of times; ``params`` the motion ground truth
    in ``models.warps`` parameter layout.
    """
    render: Callable
    flow: Callable
    params: np.ndarray
    shape: Tuple[int, int]


def _grid(texture, device):
    dev = pick_device(texture, device=device)
    tex = as_f32(texture, dev).contiguous()
    H, W = tex.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    return tex, dev, H, W, yy, xx


def _static_flow(field: torch.Tensor):
    def flow(t):
        lead = torch.as_tensor(t).shape
        return field.expand(lead + field.shape)
    return flow


def translating_scene(texture, velocity: Tuple[float, float],
                      device=None) -> Scene:
    """Texture drifting at constant ``velocity = (vx, vy)`` px/s:
    ``I(x, y, t) = T(x - vx*t, y - vy*t)`` (wrapped)."""
    tex, dev, H, W, yy, xx = _grid(texture, device)
    vx, vy = float(velocity[0]), float(velocity[1])

    def render(t):
        t = _times(t, dev)
        return _sample_wrap(tex, yy - vy * t, xx - vx * t)

    field_ = torch.stack([torch.full((H, W), vx, device=dev),
                          torch.full((H, W), vy, device=dev)])
    return Scene(render, _static_flow(field_), np.array([vx, vy], np.float64),
                 (H, W))


def rotating_scene(texture, omega: float,
                   center: Optional[Tuple[float, float]] = None,
                   device=None) -> Scene:
    """Texture rotating at ``omega`` rad/s about ``center = (cx, cy)``;
    flow ``(-omega*(y-cy), omega*(x-cx))``."""
    tex, dev, H, W, yy, xx = _grid(texture, device)
    cx, cy = center if center is not None else ((W - 1) / 2.0, (H - 1) / 2.0)

    def render(t):
        a = -omega * _times(t, dev)
        ca, sa = torch.cos(a), torch.sin(a)
        dx, dy = xx - cx, yy - cy
        return _sample_wrap(tex, cy + sa * dx + ca * dy,
                            cx + ca * dx - sa * dy)

    field_ = torch.stack([-omega * (yy - cy), omega * (xx - cx)])
    return Scene(render, _static_flow(field_),
                 np.array([cx, cy, omega], np.float64), (H, W))


def affine_scene(texture, divergence: float = 0.0, omega: float = 0.0,
                 center: Optional[Tuple[float, float]] = None,
                 device=None) -> Scene:
    """Texture expanding at ``divergence`` (1/s) while rotating at
    ``omega`` (rad/s) about ``center``; ``params`` is the xyztheta ground
    truth ``(vx, vy, s, w)`` about the image origin."""
    tex, dev, H, W, yy, xx = _grid(texture, device)
    cx, cy = center if center is not None else ((W - 1) / 2.0, (H - 1) / 2.0)
    s, w = float(divergence), float(omega)

    def render(t):
        t = _times(t, dev)
        scale = torch.exp(-s * t)
        ca, sa = torch.cos(w * t), torch.sin(w * t)
        dx, dy = xx - cx, yy - cy
        return _sample_wrap(tex, cy + scale * (-sa * dx + ca * dy),
                            cx + scale * (ca * dx + sa * dy))

    dx, dy = xx - cx, yy - cy
    field_ = torch.stack([s * dx - w * dy, s * dy + w * dx])
    gt = np.array([-s * cx + w * cy, -s * cy - w * cx, s, w], np.float64)
    return Scene(render, _static_flow(field_), gt, (H, W))


# ---------------------------------------------------------------------------
# The simulator core
# ---------------------------------------------------------------------------

@dataclass
class SimulatorConfig:
    """Sensor model parameters (defaults are DAVIS-like)."""
    c_pos: float = 0.25          # positive contrast threshold (log units)
    c_neg: float = 0.25          # negative contrast threshold
    sigma_c: float = 0.0         # per-pixel threshold mismatch (log-normal σ)
    refractory: float = 0.0      # seconds a pixel is dead after an event
    noise_std: float = 0.0       # additive log-intensity noise per frame
    log_eps: float = 1e-3        # L = log(I + log_eps)
    max_events_per_pixel: int = 8  # K slots per pixel per frame pair
    chunk: int = 64              # frame pairs per compaction
    # Background activity (spurious events independent of the signal):
    leak_rate_hz: float = 0.0    # per-pixel Poisson rate of ON leak events
    shot_rate_hz: float = 0.0    # per-pixel random-polarity shot noise rate
    hot_pixel_fraction: float = 0.0  # fraction of pixels that are "hot"
    hot_pixel_rate_hz: float = 100.0  # per-hot-pixel extra ON-leak rate
    max_noise_events_per_pixel: int = 4  # Kn noise slots per pixel/interval

    def has_noise_events(self) -> bool:
        return (self.leak_rate_hz > 0.0 or self.shot_rate_hz > 0.0
                or (self.hot_pixel_fraction > 0.0
                    and self.hot_pixel_rate_hz > 0.0))


@dataclass
class SimulatedEvents:
    """Compacted, time-sorted event stream (host arrays) + statistics.

    ``stats['dropped']`` counts suppressed firing *attempts* (capacity
    overflow plus refractory gating). ``labels`` (only with background
    activity, else ``None``) tags each event 0 = contrast crossing,
    1 = noise.
    """
    xs: np.ndarray
    ys: np.ndarray
    ts: np.ndarray
    ps: np.ndarray
    stats: Dict[str, int] = field(default_factory=dict)
    labels: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.ts)


def _threshold_maps(root: Optional[int], shape, cfg: SimulatorConfig,
                    device):
    cp = torch.full(shape, cfg.c_pos, dtype=torch.float32, device=device)
    cn = torch.full(shape, cfg.c_neg, dtype=torch.float32, device=device)
    if cfg.sigma_c > 0.0:
        if root is None:
            raise ConfigurationError(
                "sigma_c > 0 requires an explicit generator")
        for c, purpose in ((cp, _THRESH_POS), (cn, _THRESH_NEG)):
            z = torch.randn(shape, device=device,
                            generator=_stream(root, purpose, 0, device))
            c.mul_(torch.exp(cfg.sigma_c * z))
    return torch.clamp(cp, min=1e-2), torch.clamp(cn, min=1e-2)


def _hot_map(root: int, shape, cfg: SimulatorConfig, device):
    u = torch.rand(shape, device=device,
                   generator=_stream(root, _HOT, 0, device))
    return u < cfg.hot_pixel_fraction


def hot_pixel_map(generator: torch.Generator, shape: Tuple[int, int],
                  cfg: SimulatorConfig, device=None) -> torch.Tensor:
    """The ``(H, W)`` bool map of hot pixels that :func:`simulate_events`
    and :func:`simulate_events_device` plant for a generator in the same
    state (e.g. seeded alike)."""
    return _hot_map(_root_seed(generator), tuple(shape), cfg,
                    resolve_device(device))


def _validate_noise_cfg(cfg: SimulatorConfig, generator) -> None:
    if (cfg.leak_rate_hz < 0.0 or cfg.shot_rate_hz < 0.0
            or cfg.hot_pixel_rate_hz < 0.0
            or not 0.0 <= cfg.hot_pixel_fraction <= 1.0):
        raise ConfigurationError(
            "leak_rate_hz/shot_rate_hz/hot_pixel_rate_hz must be >= 0 and "
            "hot_pixel_fraction within [0, 1]")
    if cfg.has_noise_events() and generator is None:
        raise ConfigurationError(
            "leak/hot-pixel noise events require an explicit generator")


def _check_noise_capacity(cfg: SimulatorConfig, dt_max: float) -> None:
    """Fail loudly when the static noise-slot capacity cannot hold the
    configured background activity (``min(Poisson(rate·dt), Kn)`` per
    pixel per interval would silently truncate the tail)."""
    rate_max = cfg.leak_rate_hz + cfg.shot_rate_hz + (
        cfg.hot_pixel_rate_hz if cfg.hot_pixel_fraction > 0.0 else 0.0)
    lam = rate_max * float(dt_max)
    need = lam + 4.0 * np.sqrt(lam) + 1.0  # P(Poisson(λ) > need) ~ 3e-5
    if need > cfg.max_noise_events_per_pixel:
        raise ConfigurationError(
            f"max_noise_events_per_pixel={cfg.max_noise_events_per_pixel} "
            f"cannot hold the configured background activity (up to "
            f"λ={lam:.1f} noise events per pixel per frame interval): "
            f"raise it to >= {int(np.ceil(need))} or increase the frame "
            "rate")


def _noise_rate_maps(root: int, shape, cfg: SimulatorConfig, device):
    """Per-pixel noise-event Poisson rate and ON-polarity probability:
    leak (ON) at ``leak_rate_hz``, shot noise (either sign) at
    ``shot_rate_hz``, and ``hot_pixel_rate_hz`` of extra leak on a random
    ``hot_pixel_fraction`` of pixels."""
    hot = (_hot_map(root, shape, cfg, device).float() * cfg.hot_pixel_rate_hz
           if cfg.hot_pixel_fraction > 0.0
           else torch.zeros(shape, dtype=torch.float32, device=device))
    rate = cfg.leak_rate_hz + cfg.shot_rate_hz + hot
    p_on = torch.where(
        rate > 0.0,
        (cfg.leak_rate_hz + hot + 0.5 * cfg.shot_rate_hz)
        / torch.clamp(rate, min=1e-30),
        1.0)
    return rate, p_on


def _noise_interval(root, index, t0, t1, rate, p_on, Kn):
    """Noise slots of one interval: ``n ~ min(Poisson(rate·dt), Kn)``
    events per pixel at uniform times in ``[t0, t1)`` (f32 scalars), from
    the generator of the ABSOLUTE interval ``index``."""
    dev = rate.device
    g = _stream(root, _NOISE_SLOTS, index, dev)
    dt = float(np.float32(t1) - np.float32(t0))
    n = torch.clamp(torch.poisson(rate * dt, generator=g), max=Kn)
    valid = torch.arange(Kn, device=dev) < n[..., None]
    u = torch.rand(rate.shape + (Kn,), generator=g, device=dev)
    t = float(t0) + u * dt
    on = torch.rand(rate.shape + (Kn,), generator=g, device=dev) \
        < p_on[..., None]
    sign = torch.where(on, 1, -1).to(torch.int8)
    return t, valid, sign


def _step(L_ref, t_last, L0, L1, t0, t1, cp, cn, K, rho, j):
    """One frame pair of B scenes: the crossings of ``L0 -> L1`` against
    ``L_ref`` (all ``(B, H, W)``; the thresholds broadcast).

    ``t0``, ``t1`` are f32 values (Python floats holding them exactly).
    Returns the new state and ``(t_ev (B, H, W, K), kept, sign (B, H, W)
    int8, dropped (B,))``.
    """
    dL = L1 - L_ref
    up = dL >= 0
    sign = torch.where(up, 1.0, -1.0)
    C = torch.where(up, cp, cn)
    n = torch.floor(dL.abs() / C).to(torch.int32)
    overflow = torch.clamp(n - K, min=0)
    n = torch.clamp(n, max=K)
    levels = L_ref[..., None] + (sign * C)[..., None] * j       # (H, W, K)
    denom = (L1 - L0)[..., None]
    flat = denom.abs() < 1e-12
    frac = torch.where(flat, 1.0,
                       (levels - L0[..., None]) / torch.where(flat, 1.0,
                                                              denom))
    dt = float(np.float32(t1) - np.float32(t0))
    t_ev = t0 + torch.clamp(frac, 0.0, 1.0) * dt
    valid = j <= n[..., None].float()
    if rho > 0.0:
        # sequential refractory gate along K: an event is kept only if it
        # trails the previous KEPT event at its pixel by >= rho
        cols = []
        prev_t = t_last
        for k in range(K):
            keep_k = valid[..., k] & (t_ev[..., k] >= prev_t + rho)
            cols.append(keep_k)
            prev_t = torch.where(keep_k, t_ev[..., k], prev_t)
        kept = torch.stack(cols, dim=-1)
        new_t_last = prev_t
    else:
        kept = valid
        new_t_last = torch.where(
            n > 0,
            torch.where(kept, t_ev, -torch.inf).amax(dim=-1),
            t_last)
    n_kept = kept.sum(dim=-1).float()
    # L_ref advances over KEPT crossings only: a refractory-dropped
    # crossing re-fires once the pixel wakes up
    new_L_ref = L_ref + sign * C * n_kept
    dropped = (valid & ~kept).sum((-3, -2, -1)) + overflow.sum((-2, -1))
    return new_L_ref, new_t_last, (t_ev, kept, sign.to(torch.int8), dropped)


def _check_frames(frames, n_ts, ndim=3):
    """Frames ``(F, H, W)`` (``ndim`` 3) or ``(B, F, H, W)`` (4) against
    ``n_ts`` stamps; returns the shape."""
    shape = tuple(frames.shape) if hasattr(frames, "shape") \
        else np.shape(frames)
    if len(shape) != ndim or shape[-3] != n_ts:
        raise ConfigurationError(
            f"frames {shape} / frame_ts ({n_ts},) mismatch")
    if shape[-3] < 2:
        raise ConfigurationError("need at least two frames to simulate")
    return shape


def _host_stamps(frame_ts) -> np.ndarray:
    if isinstance(frame_ts, torch.Tensor):
        frame_ts = frame_ts.detach().cpu().numpy()
    return np.asarray(frame_ts, np.float64).reshape(-1)


def _log_frame(frames, i, cfg, root):
    """``log(frame_i + eps)`` of ``frames (B, F, H, W)``, plus the frame's
    own log-intensity noise (drawn from the generator of the absolute frame
    index ``i``; one scene only)."""
    L = torch.log(frames[:, i] + cfg.log_eps)
    if cfg.noise_std > 0.0:
        z = torch.randn(L.shape[-2:], device=L.device,
                        generator=_stream(root, _FRAME_NOISE, i, L.device))
        L = L + cfg.noise_std * z
    return L


def _prepare(frames, cfg, generator, device):
    """Frames on the device and the run seed; shared by both simulators."""
    dev = pick_device(frames, device=device)
    frames = as_f32(frames, dev)
    if cfg.noise_std > 0.0 and generator is None:
        raise ConfigurationError(
            "noise_std > 0 requires an explicit generator")
    _validate_noise_cfg(cfg, generator)
    root = None if generator is None else _root_seed(generator)
    return frames, dev, root


def _scan(frames, stamps32, cfg, root):
    """The crossing scan of ``frames (B, F, H, W)`` over every frame pair,
    in order: yields ``(i, t_ev (B, H, W, K), kept, sign (B, H, W) int8,
    dropped (B,))`` for interval ``i`` (``stamps32``: the frame stamps as
    float32 numpy). Each scene's arithmetic is the one-scene scan's: every
    operation is elementwise along B, H, W and K."""
    dev = frames.device
    B, F_, H, W = frames.shape
    cp, cn = _threshold_maps(root, (H, W), cfg, dev)
    K = int(cfg.max_events_per_pixel)
    j = torch.arange(1, K + 1, dtype=torch.float32, device=dev)
    L0 = _log_frame(frames, 0, cfg, root)
    L_ref = L0
    t_last = torch.full((B, H, W), -torch.inf, device=dev)
    for i in range(F_ - 1):
        L1 = _log_frame(frames, i + 1, cfg, root)
        L_ref, t_last, out = _step(L_ref, t_last, L0, L1,
                                   float(stamps32[i]), float(stamps32[i + 1]),
                                   cp, cn, K, float(cfg.refractory), j)
        yield (i,) + out
        L0 = L1


def simulate_events(frames, frame_ts, cfg: Optional[SimulatorConfig] = None,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> SimulatedEvents:
    """Run the sensor model over intensity ``frames (F, H, W)`` in (0, 1].

    Runs on ``frames``' device if it is a tensor, else on ``device``
    (default ``"cuda"``). Returns the compacted time-sorted stream as host
    arrays. The scan runs in float32 *relative* time (``frame_ts -
    frame_ts[0]``) and the float64 origin is added back, so epoch-style
    stamps survive at full precision. Noise is drawn from ``generator``
    (required when a noise option is on), keyed on absolute frame and
    interval indices.
    """
    cfg = cfg or SimulatorConfig()
    frame_ts = _host_stamps(frame_ts)
    _check_frames(frames, len(frame_ts))
    if np.any(np.diff(frame_ts) <= 0):
        raise ConfigurationError("frame_ts must be strictly increasing")
    frames, dev, root = _prepare(frames, cfg, generator, device)
    F_, H, W = frames.shape
    noise = None
    if cfg.has_noise_events():
        _check_noise_capacity(cfg, np.diff(frame_ts).max())
        noise = _noise_rate_maps(root, (H, W), cfg, dev)
    Kn = int(cfg.max_noise_events_per_pixel)

    t_origin = frame_ts[0]
    rel_ts = (frame_ts - t_origin).astype(np.float32)
    blocks = []
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    noise_total = 0
    chunk = max(1, int(cfg.chunk))
    steps = _scan(frames[None], rel_ts, cfg, root)
    for start in range(0, F_ - 1, chunk):
        stop = min(start + chunk, F_ - 1)
        t_c, kept_c, sign_c = [], [], []
        for _, t_ev, kept, sign, d in itertools.islice(steps, stop - start):
            dropped += d[0]
            t_c.append(t_ev[0])
            kept_c.append(kept[0])
            sign_c.append(sign[0])
        kept = torch.stack(kept_c)                  # (steps, H, W, K)
        si, iy, ix, _ = torch.nonzero(kept, as_tuple=True)
        if len(si):
            blocks.append((ix, iy, torch.stack(t_c)[kept],
                           torch.stack(sign_c)[si, iy, ix], 0))
        if noise is not None:
            out = [_noise_interval(root, i, rel_ts[i], rel_ts[i + 1],
                                   *noise, Kn) for i in range(start, stop)]
            n_t, n_valid, n_sign = (torch.stack(a) for a in zip(*out))
            _, niy, nix, _ = torch.nonzero(n_valid, as_tuple=True)
            if len(niy):
                blocks.append((nix, niy, n_t[n_valid], n_sign[n_valid], 1))
                noise_total += len(niy)

    dropped = int(dropped)
    if not blocks:
        empty = np.array([], np.float32)
        return SimulatedEvents(empty, empty, empty.astype(np.float64), empty,
                               {"num_events": 0, "dropped": dropped,
                                "num_pos": 0, "num_neg": 0, "num_noise": 0},
                               labels=(np.array([], np.int8)
                                       if noise is not None else None))
    xs = torch.cat([b[0] for b in blocks]).float()
    ys = torch.cat([b[1] for b in blocks]).float()
    ts = torch.cat([b[2] for b in blocks]).double() + float(t_origin)
    ps = torch.cat([b[3] for b in blocks]).float()
    ts, order = torch.sort(ts, stable=True)
    labels = None
    if noise is not None:
        labels = torch.cat([torch.full((len(b[0]),), b[4], dtype=torch.int8,
                                       device=dev) for b in blocks])[order]
        labels = labels.cpu().numpy()
    ps = ps[order]
    stats = {"num_events": len(ts), "dropped": dropped,
             "num_pos": int((ps > 0).sum()), "num_neg": int((ps < 0).sum()),
             "num_noise": noise_total}
    return SimulatedEvents(xs[order].cpu().numpy(), ys[order].cpu().numpy(),
                           ts.cpu().numpy(), ps.cpu().numpy(), stats,
                           labels=labels)


def simulate_events_device(frames, frame_ts, capacity: int,
                           cfg: Optional[SimulatorConfig] = None,
                           generator: Optional[torch.Generator] = None,
                           dt_max: Optional[float] = None,
                           return_overflow: bool = False, device=None):
    """Simulation into ONE capacity-padded event batch on the device.

    Same sensor model as :func:`simulate_events`, in float32 *absolute*
    time as in JAX; the ``(F-1, H, W, K)`` slots (then the noise slots)
    are flattened and sorted by ``where(valid, t, inf)`` with a stable
    sort, and the first ``capacity`` come back as ``(events (capacity, 4),
    mask (capacity,))`` tensors: the EARLIEST events when more fired. Pads
    have zero coordinates and polarity and repeat the last valid stamp.
    ``return_overflow`` adds the exact number of events the cut dropped.
    ``dt_max`` overrides the largest frame interval for the noise-slot
    capacity check. The one-scene case of
    :func:`simulate_events_device_batch`.
    """
    cfg = cfg or SimulatorConfig()
    stamps = _host_stamps(frame_ts)
    _check_frames(frames, len(stamps))
    frames, _, root = _prepare(frames, cfg, generator, device)
    ev, mask, overflow = _device_batch(frames[None], stamps, capacity, cfg,
                                       root, dt_max)
    if return_overflow:
        return ev[0], mask[0], overflow[0]
    return ev[0], mask[0]


def simulate_events_device_batch(frames, frame_ts, capacity: int,
                                 cfg: Optional[SimulatorConfig] = None,
                                 generator: Optional[torch.Generator] = None,
                                 dt_max: Optional[float] = None,
                                 device=None):
    """:func:`simulate_events_device` of B scenes in one frame loop (JAX's
    ``jax.vmap`` of it over the scenes): ``frames (B, F, H, W)`` at the
    common stamps ``frame_ts (F,)``; returns ``(events (B, capacity, 4),
    mask (B, capacity), overflow (B,))``, row b exactly what the one-scene
    call gives on ``frames[b]``.

    The noise options (``noise_std``, ``sigma_c``, leak, shot and hot
    pixels) draw from one generator for one scene, so with B > 1 they raise
    ``ConfigurationError``: simulate such scenes one at a time with
    :func:`simulate_events_device`.
    """
    cfg = cfg or SimulatorConfig()
    stamps = _host_stamps(frame_ts)
    B = _check_frames(frames, len(stamps), ndim=4)[0]
    if B > 1 and (cfg.noise_std > 0.0 or cfg.sigma_c > 0.0
                  or cfg.has_noise_events()):
        raise ConfigurationError(
            "the noise options draw for one scene: simulate noisy scenes one "
            "at a time with simulate_events_device")
    frames, _, root = _prepare(frames, cfg, generator, device)
    return _device_batch(frames, stamps, capacity, cfg, root, dt_max)


def _device_batch(frames, stamps, capacity, cfg, root, dt_max):
    """The scan of ``frames (B, F, H, W)`` on their device compacted into
    ``(events (B, capacity, 4), mask (B, capacity), overflow (B,))``: one
    stable sort of the ``(B, slots)`` keys ``where(valid, t, inf)``, the
    first ``capacity`` slots of each row, the coordinates and polarity of
    those slots read off their index, pads per row."""
    dev = frames.device
    B, F_, H, W = frames.shape
    ts32 = stamps.astype(np.float32)
    K = int(cfg.max_events_per_pixel)
    _, t_c, kept_c, sign_c, _ = zip(*_scan(frames, ts32, cfg, root))
    steps = F_ - 1
    # slot ((i H + y) W + x) K + k of a row: crossing k of pixel (y, x) in
    # interval i; its polarity is the pixel's sign in that interval
    tt = torch.stack(t_c, 1).reshape(B, -1)
    valid = torch.stack(kept_c, 1).reshape(B, -1)
    sign = torch.stack(sign_c, 1).reshape(B, -1)
    n_cross = tt.shape[1]
    noise = cfg.has_noise_events()
    if noise:   # one scene: its noise slots follow, Kn per pixel
        _check_noise_capacity(cfg, float(dt_max) if dt_max is not None
                              else float(np.diff(ts32).max()))
        maps = _noise_rate_maps(root, (H, W), cfg, dev)
        Kn = int(cfg.max_noise_events_per_pixel)
        out = [_noise_interval(root, i, ts32[i], ts32[i + 1], *maps, Kn)
               for i in range(steps)]
        n_t, n_valid, n_sign = (torch.stack(a).reshape(1, -1)
                                for a in zip(*out))
        tt = torch.cat([tt, n_t], 1)
        valid = torch.cat([valid, n_valid], 1)
    overflow = torch.clamp(valid.sum(1) - capacity, min=0)
    order = torch.argsort(torch.where(valid, tt, torch.inf), dim=1,
                          stable=True)[:, :capacity]
    mask = valid.gather(1, order).float()
    t_sel = tt.gather(1, order)
    pix = order // max(K, 1)            # (interval, pixel) of the slot
    if noise:
        cross = order < n_cross
        slot = torch.clamp(order - n_cross, min=0)
        pix = torch.where(cross, pix, slot // Kn)
        pol = torch.where(cross, sign.gather(1, pix), n_sign.gather(1, slot))
    else:
        pol = sign.gather(1, pix)
    pix = pix % (H * W)
    # pads: zero coordinates and polarity, the row's last valid stamp (each
    # row stays time-sorted end to end)
    t_pad = torch.where(mask != 0, t_sel, -torch.inf).amax(1) \
        if order.shape[1] else torch.full((B,), -torch.inf, device=dev)
    t_pad = torch.where(torch.isfinite(t_pad), t_pad, 0.0)
    t_col = torch.where(mask != 0, t_sel, t_pad[:, None])
    ev = torch.stack([(pix % W).float() * mask, (pix // W).float() * mask,
                      t_col, pol.float() * mask], dim=-1)
    pad_out = capacity - order.shape[1]
    if pad_out > 0:
        pad = torch.zeros((B, pad_out, 4), device=dev)
        pad[..., 2] = t_pad[:, None]
        ev = torch.cat([ev, pad], 1)
        mask = torch.cat([mask, torch.zeros((B, pad_out), device=dev)], 1)
    return ev, mask, overflow


def simulate_scene(scene: Scene, duration: float, fps: float,
                   cfg: Optional[SimulatorConfig] = None,
                   generator: Optional[torch.Generator] = None):
    """Render ``scene`` at ``fps`` for ``duration`` seconds and simulate,
    on the scene's device.

    Returns ``(events, frames, frame_ts, flows)``: frames ``(F, H, W)``
    and flows ``(F, 2, H, W)`` (px/s) as host arrays, rendered in batches
    of ``cfg.chunk`` times (cast to float32, as in JAX).
    """
    if duration <= 0 or fps <= 0:
        raise ConfigurationError("duration and fps must be positive")
    cfg = cfg or SimulatorConfig()
    n_frames = max(2, int(round(duration * fps)) + 1)
    frame_ts = np.linspace(0.0, duration, n_frames)
    chunk = max(1, int(cfg.chunk))
    ts32 = torch.as_tensor(frame_ts.astype(np.float32))
    frames = torch.cat([scene.render(ts32[s:s + chunk])
                        for s in range(0, n_frames, chunk)])
    flows = np.concatenate([scene.flow(ts32[s:s + chunk]).cpu().numpy()
                            for s in range(0, n_frames, chunk)])
    events = simulate_events(frames, frame_ts, cfg, generator)
    return events, frames.cpu().numpy(), frame_ts, flows
