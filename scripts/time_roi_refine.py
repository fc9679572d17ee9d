#!/usr/bin/env python3
"""Card time of the ROI solver's patch loss and of the warm refine's CUDA
graph, on the rotating scene that the benchmark's roi-stream cell streams.

    python3 scripts/time_roi_refine.py [--windows 300] [--seed 3]

Two parts, one JSON line each on stdout:

- ``evaluation``: one evaluation of the solver's patch loss
  (``events_cmax._roi_patch_loss``: variance, linear velocity, 108 ROIs of
  20 x 20 in (64, 128) patches, the 181 x 241 frame) on one bucketed
  20k-event window at capacities 1024 and 2048, value and gradient
  (autograd) and value alone: device ms a call (CUDA events over a CUDA
  graph of 10 calls, median of 20 replays) and the kernel routes one call
  launches;
- ``stream``: ``--windows`` consecutive windows solved as
  ``cli/stream_flow.py`` solves them (warm-started from the last field,
  invalid ROIs zeroed, GD, 30 steps): per warm window the host wall of the
  solve up to its answer on the host, the program's spans (``cmax.bucket``,
  ``cmax.descent``), and the card time of the refine graph's replay (CUDA
  events around ``graph.replay()``): medians and 95th percentiles; then a
  ``torch.profiler`` slice over 5 warm windows: kernels and device busy
  time a window.

It uses only what checkouts with the refine's CUDA graphs
(``events_cmax._CudaGraphs``) already have, so it runs from an older
checkout's root too and two versions compare in one call. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

SENSOR = (180, 240)
ROI = (20, 20)
K_EVENTS = 20_000


def rotating_windows(n_windows, seed):
    """Consecutive 20k-event windows of the rotating scene (400 points at
    1.2 rad/s about the centre of 180 x 240, 1 M draws a second, 0.2 px
    jitter, integer pixels)."""
    rng = np.random.default_rng(seed)
    H, W = SENSOR
    n = int(K_EVENTS * n_windows * 1.1)
    px, py = rng.uniform(10, W - 10, 400), rng.uniform(10, H - 10, 400)
    pol = rng.choice([-1.0, 1.0], 400)
    idx = rng.integers(0, 400, n)
    ts = np.sort(rng.uniform(0, n / 1e6, n))
    rx, ry = px[idx] - W / 2, py[idx] - H / 2
    ca, sa = np.cos(1.2 * ts), np.sin(1.2 * ts)
    xs = W / 2 + ca * rx - sa * ry + rng.normal(0, 0.2, n)
    ys = H / 2 + sa * rx + ca * ry + rng.normal(0, 0.2, n)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    ev = [np.floor(xs[keep]), np.floor(ys[keep]), ts[keep], pol[idx][keep]]
    ev = [a.astype(np.float32) for a in ev]
    return [tuple(a[j * K_EVENTS:(j + 1) * K_EVENTS] for a in ev)
            for j in range(n_windows)]


def graph_ms(torch, fn, calls=10, reps=20):
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the median over ``reps`` replays timed with CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def evaluation(torch, ec, cs, window):
    out = {}
    loss = ec._roi_patch_loss(ec.linvel_warp(), ec.variance_objective(),
                              SENSOR, ROI, 1.0)
    for capacity in (1024, 2048):
        bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
            *window, SENSOR, ROI, capacity=capacity, device="cuda")
        ev = (bx, by, bt, bp, bm, org.to(torch.float32))
        g = np.random.default_rng(capacity)
        p = torch.as_tensor(g.normal(0, 30, (bx.shape[0], 2)),
                            dtype=torch.float32, device="cuda")

        def value_and_grad():
            q = p.detach().requires_grad_(True)
            with torch.enable_grad():
                v = loss(q, *ev)
                (gr,) = torch.autograd.grad(v.sum(), q)
            return v, gr

        def value():
            with torch.no_grad():
                return loss(p, *ev)

        row = {}
        for name, fn in (("value_and_grad", value_and_grad),
                         ("value", value)):
            fn()
            torch.cuda.synchronize()
            before = cs.launch_counts()
            fn()
            torch.cuda.synchronize()
            row[f"{name}_launches"] = {
                k: v - before[k] for k, v in cs.launch_counts().items()
                if v != before[k]}
            row[f"{name}_ms"] = graph_ms(torch, fn)
        out[f"R{bx.shape[0]}xC{capacity}"] = row
    return out


def stream(torch, ec, profiling, windows):
    from torch.profiler import ProfilerActivity, profile

    events = []
    replay = ec._CudaGraphs.replay

    def timed_replay(device, graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        replay(device, graph)
        b.record()
        events.append((a, b))

    ec._CudaGraphs.replay = staticmethod(timed_replay)
    was = profiling.enable_spans(True)
    profiling.take()
    prev = None
    rows = []

    def solve(window):
        nonlocal prev
        t0 = time.perf_counter()
        params, _, _, valid = ec.grid_cmax_batched(
            *window, roi_size=ROI, img_size=SENSOR, min_events=10,
            maxiter=30, x0=prev, pyramid=1, device="cuda")
        params, valid = params.cpu().numpy(), valid.cpu().numpy()
        wall = time.perf_counter() - t0
        prev = np.where(valid[:, None], params, 0.0).astype(np.float32)
        return wall

    try:
        for window in windows[:-5]:
            del events[:]
            wall = solve(window)
            totals = profiling.totals(profiling.take().spans)
            card = None
            if events:
                a, b = events[0]
                card = a.elapsed_time(b)
            rows.append((wall * 1e3, totals.get("cmax.bucket", 0.0) * 1e3,
                         totals.get("cmax.descent", 0.0) * 1e3, card))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for window in windows[-5:]:
                solve(window)
            torch.cuda.synchronize()
    finally:
        profiling.enable_spans(was)
        ec._CudaGraphs.replay = staticmethod(replay)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = sum(by_name.values()) / 1e3
    warm = [r for r in rows[2:] if r[3] is not None]

    def stat(i):
        v = np.array([r[i] for r in warm])
        return {"median": float(np.median(v)),
                "p95": float(np.percentile(v, 95))}

    return {"windows": len(rows), "replayed": len(warm),
            "wall_ms": stat(0), "bucket_ms": stat(1),
            "descent_ms": stat(2), "replay_card_ms": stat(3),
            "profiled": {"windows": 5, "device_entries": len(kernels) / 5,
                         "busy_ms": busy_ms / 5,
                         "top_us_a_window": [[k[:60], v / 5]
                                             for k, v in top]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    import subprocess

    import torch

    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.ops import cuda_scatter as cs
    from event_utils_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    windows = rotating_windows(args.windows + 1, args.seed)
    print(json.dumps({"evaluation": evaluation(torch, ec, cs, windows[0]),
                      "card": card}), flush=True)
    print(json.dumps({"stream": stream(torch, ec, profiling, windows[1:]),
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
