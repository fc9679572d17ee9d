#!/usr/bin/env python3
"""Write the training data that the port carries over from JAX.

    JAX_PLATFORMS=cpu python3 scripts/make_train_eval_scenes.py

The JAX trainers draw two things from threefry keys that
``torch.Generator`` cannot reproduce, so they are data, like the
simulator's textures (``scripts/make_sim_textures.py``):

- the perceptual loss's fixed random filters
  (``event_utils_tpu/models/networks.py:232-264``: three levels of 16
  filters from ``jax.random.PRNGKey(0)``), written as
  ``perceptual_filters.npz``;
- the scene parameters of the two pinned held-out eval batches behind the
  committed weights, both drawn with ``--eval_seed 0``
  (``event_utils_tpu/training/in_the_loop.py:561-564`` and :400-403):
  the stage-9 flow batch of ``runs/flow128_similarity`` (8 scenes at
  128x128, similarity family, ``omega_max`` 6, ``s_max`` 0.6) and the
  stage-8 reconstruction batch of ``runs/recon128v2`` (4 translating
  scenes, 24 windows). For each scene its texture, velocity ``v`` and
  ``(omega, s)``, written as ``flow_eval_scenes.npz`` and
  ``recon_eval_scenes.npz``.

It also writes ``eval_anchors.json``: on each real JAX eval batch (the
package's own ``simulate_flow_batch`` / ``simulate_recon_batch`` on the
eval key, run here on the CPU), the per-scene event counts, and the
committed weights' held-out AEE and zero-flow baseline (flow) and PSNR /
SSIM over all windows and the steady windows (reconstruction), computed as
the JAX trainers' evals compute them. It checks that the JAX simulator
rebuilt from the written parameters gives the same counts.

Everything goes into ``event_utils_tpu_torch/training/data/``. The port
reads these files (``training.in_the_loop.load_scenes``,
``models.networks.perceptual_filters``) and never calls this script, which
needs the JAX package. Takes about a minute and a few GiB of memory.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "event_utils_tpu_torch", "training", "data")
SENSOR = (128, 128)
OCTAVES = 3
EVAL_SEED = 0
# runs/flow128_similarity/metrics_stage9.json's config (the eval batch is
# drawn with fresh_prob = age_max = 0)
FLOW = dict(batch_size=8, capacity=65536, v_max=40.0, window_t=0.1,
            num_frames=9, omega_max=6.0, s_max=0.6, burn_in=1)
FLOW_PARAMS = os.path.join(ROOT, "runs", "flow128_similarity", "params.npz")
# runs/recon128v2/metrics_stage8.json's config
RECON = dict(batch_size=4, capacity=294912, seq_len=8, carry_segments=3,
             v_max=40.0, window_t=0.05, sim_steps_per_window=4, num_bins=5,
             burn_in=1, ema_decay=0.999,
             model_kwargs={"recurrent_levels": 3, "num_res_blocks": 2})
RECON_PARAMS = os.path.join(ROOT, "runs", "recon128v2", "params.npz")
PERCEPTUAL = dict(levels=3, features=16, seed=0, in_channels=1)


def perceptual_filters():
    """The filters ``_perceptual_pyramid`` draws, as it scales them."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(PERCEPTUAL["seed"])
    in_ch, out = PERCEPTUAL["in_channels"], {}
    for lvl in range(PERCEPTUAL["levels"]):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (PERCEPTUAL["features"], in_ch, 3, 3),
                              jnp.float32)
        out[f"level{lvl}"] = np.asarray(w / jnp.sqrt(9.0 * in_ch))
        in_ch = PERCEPTUAL["features"]
    return out


def eval_key():
    import jax
    _, k_eval = jax.random.split(jax.random.PRNGKey(EVAL_SEED))
    return k_eval


def scene_params(k_eval, batch_size, v_max, omega_max=0.0, s_max=0.0):
    """Texture, v and (omega, s) of each eval scene: the draws of
    ``simulate_flow_batch`` / ``simulate_recon_batch``'s ``one(k)``, under
    ``jit(vmap)`` as there."""
    import jax
    import jax.numpy as jnp

    from event_utils_tpu.simulation.esim import smooth_texture

    similarity = bool(omega_max or s_max)

    def one(k):
        if similarity:
            k_tex, k_vel, k_rot, _ = jax.random.split(k, 4)
            ws = jax.random.uniform(k_rot, (2,), minval=-1.0, maxval=1.0) \
                * jnp.asarray([omega_max, s_max], jnp.float32)
        else:
            k_tex, k_vel, _ = jax.random.split(k, 3)
            ws = jnp.zeros(2, jnp.float32)
        tex = smooth_texture(k_tex, SENSOR, octaves=OCTAVES)
        v = jax.random.uniform(k_vel, (2,), minval=-v_max, maxval=v_max)
        return tex, v, ws

    tex, v, ws = jax.jit(jax.vmap(one))(jax.random.split(k_eval, batch_size))
    return {"texture": np.asarray(tex, np.float32),
            "v": np.asarray(v, np.float32), "ws": np.asarray(ws, np.float32)}


def rebuilt_counts(scenes, fts, capacity, keep=None):
    """Per-scene event counts of the JAX simulator run on the written
    parameters (age 0), optionally only events with ``keep(t)``."""
    import jax
    import jax.numpy as jnp

    from event_utils_tpu.simulation.esim import (SimulatorConfig,
                                                 simulate_events_device)
    from event_utils_tpu.training.in_the_loop import _render_similarity

    cfg = SimulatorConfig(c_pos=0.15, c_neg=0.15)

    def one(tex, v, ws):
        frames = jax.vmap(lambda t: _render_similarity(tex, v, ws[0], ws[1],
                                                       t))(fts)
        ev, mask = simulate_events_device(frames, fts, capacity, cfg)
        if keep is not None:
            mask = mask * keep(ev[:, 2]).astype(mask.dtype)
        return mask.sum()

    return np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(scenes["texture"]), jnp.asarray(scenes["v"]),
        jnp.asarray(scenes["ws"]))).astype(np.int64)


def flow_anchors(k_eval):
    import jax
    import jax.numpy as jnp

    from event_utils_tpu.representations.voxel_grid import (
        events_to_neg_pos_voxel)
    from event_utils_tpu.training import FlowTrainer, simulate_flow_batch
    from event_utils_tpu.training.checkpointing import load_params_npz

    H, W = SENSOR
    ev, mask, gt, sat = simulate_flow_batch(
        k_eval, FLOW["batch_size"], SENSOR, FLOW["capacity"],
        v_max=FLOW["v_max"], window_t=FLOW["window_t"],
        num_frames=FLOW["num_frames"], omega_max=FLOW["omega_max"],
        s_max=FLOW["s_max"], burn_in=FLOW["burn_in"], fresh_prob=0.0,
        age_max=0.0, return_saturation=True)

    def vox(e, m):
        vp, vn = events_to_neg_pos_voxel(e[:, 0], e[:, 1], e[:, 2], e[:, 3],
                                         5, sensor_size=(H, W), mask=m)
        return jnp.concatenate([vp, vn], 0)

    voxel = jax.jit(jax.vmap(vox))(ev, mask)
    trainer = FlowTrainer(sensor_size=SENSOR, num_bins=5,
                          supervised_weight=1.0)
    step = load_params_npz(trainer, FLOW_PARAMS)
    flow = trainer.model.apply(trainer.params, voxel)
    aee = float(jnp.mean(jnp.linalg.norm(flow - gt, axis=1)))
    zero = float(jnp.mean(jnp.linalg.norm(gt, axis=1)))
    return {"events": np.asarray(mask.sum(1)).astype(np.int64).tolist(),
            "saturated": np.asarray(sat).tolist(), "aee_px_s": aee,
            "zero_flow_aee_px_s": zero, "params_step": step}


def recon_anchors(k_eval):
    import jax.numpy as jnp

    from event_utils_tpu.training import (ReconstructionTrainer,
                                          simulate_recon_batch)
    from event_utils_tpu.training.checkpointing import load_params_npz
    from event_utils_tpu.utils.metrics import psnr, ssim

    T = RECON["seq_len"] * RECON["carry_segments"]
    voxels, frames, sat = simulate_recon_batch(
        k_eval, RECON["batch_size"], SENSOR, RECON["capacity"], T,
        v_max=RECON["v_max"], window_t=RECON["window_t"],
        sim_steps_per_window=RECON["sim_steps_per_window"],
        num_bins=RECON["num_bins"], return_saturation=True)
    trainer = ReconstructionTrainer(
        sensor_size=SENSOR, num_bins=RECON["num_bins"],
        model_kwargs=RECON["model_kwargs"], burn_in=RECON["burn_in"],
        ema_decay=RECON["ema_decay"])
    step = load_params_npz(trainer, RECON_PARAMS)
    imgs, _ = trainer.reconstruct(voxels)
    imgs, frames = np.asarray(imgs), np.asarray(frames)
    per_p = np.array([np.mean([float(psnr(imgs[t, b, 0], frames[t, b, 0]))
                               for b in range(imgs.shape[1])])
                      for t in range(T)])
    per_s = np.array([np.mean([float(ssim(imgs[t, b, 0], frames[t, b, 0]))
                               for b in range(imgs.shape[1])])
                      for t in range(T)])
    t0 = max(RECON["burn_in"], T // 2)
    # every event of a window weighs 1 over its bins (both polarities)
    per_window = np.asarray(jnp.sum(voxels, axis=(2, 3, 4)))   # (T, B)
    return {"voxel_sum": per_window.sum(0).tolist(),
            "saturated": np.asarray(sat).tolist(),
            "psnr_db": float(per_p.mean()), "ssim": float(per_s.mean()),
            "psnr_steady_db": float(per_p[t0:].mean()),
            "ssim_steady": float(per_s[t0:].mean()),
            "psnr_per_window": per_p.tolist(),
            "ssim_per_window": per_s.tolist(), "params_step": step}


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from event_utils_tpu.training.in_the_loop import (  # noqa: F401
        simulate_flow_batch)

    os.makedirs(OUT, exist_ok=True)
    np.savez(os.path.join(OUT, "perceptual_filters.npz"),
             **perceptual_filters())
    k_eval = eval_key()
    H, W = SENSOR

    flow_scenes = scene_params(k_eval, FLOW["batch_size"], FLOW["v_max"],
                               FLOW["omega_max"], FLOW["s_max"])
    np.savez(os.path.join(OUT, "flow_eval_scenes.npz"), **flow_scenes)
    n_total = FLOW["burn_in"] * (FLOW["num_frames"] - 1) + FLOW["num_frames"]
    fts = jnp.linspace(0.0, (FLOW["burn_in"] + 1) * FLOW["window_t"],
                       n_total)
    steady = FLOW["burn_in"] * FLOW["window_t"]
    flow = flow_anchors(k_eval)
    flow["rebuilt_events"] = rebuilt_counts(
        flow_scenes, fts, FLOW["capacity"],
        keep=lambda t: t >= steady).tolist()
    print("flow:", json.dumps(flow))

    recon_scenes = scene_params(k_eval, RECON["batch_size"], RECON["v_max"])
    np.savez(os.path.join(OUT, "recon_eval_scenes.npz"), **recon_scenes)
    T = RECON["seq_len"] * RECON["carry_segments"]
    spw = RECON["sim_steps_per_window"]
    fts = jnp.linspace(0.0, T * RECON["window_t"], T * spw + 1)
    recon = recon_anchors(k_eval)
    recon["events_in_windows"] = rebuilt_counts(
        recon_scenes, fts, RECON["capacity"],
        keep=lambda t: t > 0.0).tolist()
    print("recon:", json.dumps({k: v for k, v in recon.items()
                                if "per_window" not in k}))

    anchors = {
        "source": "scripts/make_train_eval_scenes.py, JAX on the CPU "
                  f"(jax {jax.__version__})",
        "sensor": list(SENSOR), "octaves": OCTAVES, "eval_seed": EVAL_SEED,
        "c_pos": 0.15, "c_neg": 0.15, "perceptual": PERCEPTUAL,
        "flow": {"config": FLOW, "params": "runs/flow128_similarity/"
                 "params.npz", **flow},
        "recon": {"config": RECON, "params": "runs/recon128v2/params.npz",
                  **recon}}
    with open(os.path.join(OUT, "eval_anchors.json"), "w") as f:
        json.dump(anchors, f, indent=1)
        f.write("\n")
    # the real recon batch returns grids only: every event of a window
    # weighs 1 over its bins, so their sums are its counts (to f32 sums)
    vsum, counts = np.asarray(recon["voxel_sum"]), np.asarray(
        recon["events_in_windows"])
    if (flow["rebuilt_events"] != flow["events"]
            or np.abs(vsum - counts).max() > 1e-4 * counts.max()):
        print("the simulator rebuilt from the written parameters disagrees "
              "with the real eval batch")
        return 1
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
