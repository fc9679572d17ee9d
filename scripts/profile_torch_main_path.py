#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes on the card.

    python3 scripts/profile_torch_main_path.py

Builds the scenes of ``chip_smoke.py`` and runs each phase once to warm
up, then once under ``torch.profiler``:

- ``optimize_contrast_jit(grid_search_init=True)`` and
  ``optimize_contrast(grid_search_init=True)`` on the planted 200k-event
  DAVIS240 scene;
- ``grid_cmax_batched`` on the rotating bench scene (the smoke's settings);
- ``events_to_voxel_tiled`` at 720p on 2^21 events.

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
    rng = np.random.default_rng(chip_smoke.SEED)
    big = chip_smoke.TILED_SENSORS["720p"]
    n = chip_smoke.N_VOXEL
    vx, vy = rng.integers(0, big[1], n), rng.integers(0, big[0], n)
    vt, vp = np.sort(rng.uniform(0, 0.5, n)), rng.choice([-1.0, 1.0], n)
    tiled = lambda: events_to_voxel_tiled(vx, vy, vt, vp, chip_smoke.B, big)
    for label, fn in (("optimize_contrast_jit", jit),
                      ("optimize_contrast", host),
                      ("grid_cmax_batched", roi),
                      ("events_to_voxel_tiled 720p", tiled)):
        def counted():
            cs.reset_launch_counts()
            fn()
        profile(torch, label, counted, evals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
