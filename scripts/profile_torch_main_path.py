#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes on the card.

    python3 scripts/profile_torch_main_path.py

Builds the planted 200k-event DAVIS240 scene of ``chip_smoke.py`` and runs
``optimize_contrast_jit(grid_search_init=True)`` and
``optimize_contrast(grid_search_init=True)`` once each to warm up, then once
each under ``torch.profiler``. For each it prints one JSON line: host wall
time, device busy time (sum of the card's kernel, memset and memcpy times),
the device's idle share (1 - busy / wall), the number of device activities,
the number of loss evaluations, and the activities and host operators that
take the most time. Needs a CUDA device; fails without one.
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
        "loss_evals": n_evals(),
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
        linvel_warp, optimize_contrast, optimize_contrast_jit,
        variance_objective)
    from event_utils_tpu_torch.ops import cuda_scatter as cs

    print(chip_smoke.card_line(), flush=True)
    sx, sy, st, sp = chip_smoke.planted_scene(
        np.random.default_rng(chip_smoke.SEED))
    size = chip_smoke.SENSOR

    def evals():
        # one bilinear launch per loss evaluation on this path
        n = cs.bilinear_scatter.launches
        cs.reset_launch_counts()
        return n

    jit = lambda: optimize_contrast_jit(sx, sy, st, sp, linvel_warp(),
                                        variance_objective(), img_size=size,
                                        grid_search_init=True)
    host = lambda: optimize_contrast(sx, sy, st, sp, linvel_warp(),
                                     variance_objective(), blur_sigma=1.0,
                                     img_size=size, grid_search_init=True)
    for label, fn in (("optimize_contrast_jit", jit),
                      ("optimize_contrast", host)):
        def counted():
            cs.reset_launch_counts()
            fn()
        profile(torch, label, counted, evals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
