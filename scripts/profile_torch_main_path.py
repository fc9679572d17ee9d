#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes on the card.

    python3 scripts/profile_torch_main_path.py

Builds the scenes of ``chip_smoke.py`` and runs each phase once to warm
up, then once under ``torch.profiler``:

- ``optimize_contrast_jit(grid_search_init=True)`` and
  ``optimize_contrast(grid_search_init=True)`` on the planted 200k-event
  DAVIS240 scene;
- ``grid_cmax_batched`` on the rotating bench scene (the smoke's settings),
  with the default descent and with ``solver='bfgs'``;
- ``events_to_voxel_tiled`` at 720p on 2^21 events;
- the serving path on the smoke's serving recording (128x128, 20
  ``between_frames`` windows of >= 10^6 events, made by
  ``chip_smoke.write_serving_recording``) under
  ``set_default_impl('pallas')``: one batch of ``infer_flow`` (8 windows
  fetched from ``MemMapDataset``, padded, and one EV-FlowNet call) and one
  chunk of ``reconstruct`` (8 windows and 8 recurrent E2VID steps), with
  the committed weights; the flow batch again under the default ``'xla'``
  (``index_add_`` in place of the flat kernel).

For each it prints one JSON line: host wall time, device busy time (sum of
the card's kernel, memset and memcpy times), the device's idle share
(1 - busy / wall), the number of device activities, the launches of the
port's kernels (on the solvers' paths one bilinear launch is one loss
evaluation), and the activities and host operators that take the most
time. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile(torch, label, fn, n_evals):
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up (allocator, cuDNN plans, kernel build)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = collections.defaultdict(lambda: [0.0, 0])
    host = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = dev[e.name]
            d[0] += e.time_range.elapsed_us()
            d[1] += 1
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = e.self_cpu_time_total
    busy_us = sum(v[0] for v in dev.values())
    top_dev = sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "phase": label,
        "card": torch.cuda.get_device_name(0),
        "wall_s": wall,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
        "device_activities": sum(v[1] for v in dev.values()),
        "kernel_launches": n_evals(),
        "top_device_us": [[k, v[0], v[1]] for k, v in top_dev],
        "top_host_self_us": [[k, v] for k, v in top_host],
    }), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from event_utils_tpu_torch.contrast_max import (
        grid_cmax_batched, linvel_warp, optimize_contrast,
        optimize_contrast_jit, variance_objective)
    from event_utils_tpu_torch.ops import cuda_scatter as cs
    from event_utils_tpu_torch.representations import events_to_voxel_tiled

    print(chip_smoke.card_line(), flush=True)
    sx, sy, st, sp = chip_smoke.planted_scene(
        np.random.default_rng(chip_smoke.SEED))
    size = chip_smoke.SENSOR

    def evals():
        n = cs.launch_counts()
        cs.reset_launch_counts()
        return {k: v for k, v in n.items() if v}

    jit = lambda: optimize_contrast_jit(sx, sy, st, sp, linvel_warp(),
                                        variance_objective(), img_size=size,
                                        grid_search_init=True)
    host = lambda: optimize_contrast(sx, sy, st, sp, linvel_warp(),
                                     variance_objective(), blur_sigma=1.0,
                                     img_size=size, grid_search_init=True)
    rx, ry, rt, rp = chip_smoke.rotating_scene()
    roi = lambda: grid_cmax_batched(
        rx, ry, rt, rp, roi_size=chip_smoke.ROT_ROI,
        img_size=chip_smoke.ROT_SENSOR, maxiter=chip_smoke.ROT_MAXITER,
        capacity=chip_smoke.ROT_CAPACITY)
    roi_bfgs = lambda: grid_cmax_batched(
        rx, ry, rt, rp, solver="bfgs", roi_size=chip_smoke.ROT_ROI,
        img_size=chip_smoke.ROT_SENSOR, maxiter=chip_smoke.ROT_MAXITER,
        capacity=chip_smoke.ROT_CAPACITY)
    rng = np.random.default_rng(chip_smoke.SEED)
    big = chip_smoke.TILED_SENSORS["720p"]
    n = chip_smoke.N_VOXEL
    vx, vy = rng.integers(0, big[1], n), rng.integers(0, big[0], n)
    vt, vp = np.sort(rng.uniform(0, 0.5, n)), rng.choice([-1.0, 1.0], n)
    tiled = lambda: events_to_voxel_tiled(vx, vy, vt, vp, chip_smoke.B, big)
    phases = [("optimize_contrast_jit", jit), ("optimize_contrast", host),
              ("grid_cmax_batched", roi),
              ("grid_cmax_batched(solver='bfgs')", roi_bfgs),
              ("events_to_voxel_tiled 720p", tiled)]
    with tempfile.TemporaryDirectory(prefix=".profile_serving_",
                                     dir=chip_smoke.ROOT) as work:
        phases += serving_phases(torch, work)
        for label, fn in phases:
            def counted():
                cs.reset_launch_counts()
                fn()
            profile(torch, label, counted, evals)
    return 0


def serving_phases(torch, work):
    """One warm batch of each serving CLI's loop, as (label, fn) pairs."""
    import chip_smoke
    from event_utils_tpu_torch.cli.reconstruct import (_fetch_chunk,
                                                       _pad_to_multiple_hw)
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    from event_utils_tpu_torch.ops import set_default_impl
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer)

    rec = os.path.join(work, "recording")
    chip_smoke.write_serving_recording(
        rec, np.random.default_rng(chip_smoke.SEED))
    ds = MemMapDataset(rec, device="cuda")
    flow = FlowTrainer(chip_smoke.SERVE_SENSOR, device="cuda")
    flow.load_params(chip_smoke.FLOW_PARAMS)
    recon = ReconstructionTrainer(
        chip_smoke.SERVE_SENSOR, model_kwargs={"recurrent_levels": 3,
                                               "num_res_blocks": 2},
        device="cuda")
    recon.load_params(chip_smoke.RECON_PARAMS)

    def windows(lo, hi):
        return _fetch_chunk(ds, lo, hi, _pad_to_multiple_hw)[0]

    def flow_batch():
        flow.predict(windows(8, 16)).cpu()

    def recon_chunk():
        recon.reconstruct(windows(8, 16)[:, None])[0].cpu()

    def with_impl(impl, fn):
        def run():
            set_default_impl(impl)
            fn()
        return run

    return [("infer_flow batch (8 windows)", with_impl("pallas", flow_batch)),
            ("infer_flow batch (8 windows), 'xla' default",
             with_impl("xla", flow_batch)),
            ("reconstruct chunk (8 windows)",
             with_impl("pallas", recon_chunk))]


if __name__ == "__main__":
    sys.exit(main())
