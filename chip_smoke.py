#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``event_utils_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``event_utils_tpu_torch/csrc`` and prints the build time.
2. Holds each kernel against its plain PyTorch version at the main path's
   shapes (voxel: 2^21 time-sorted events, B=5, 180x240, also masked and
   with a t1 override; bilinear: K=1 and K=4 at 181x241 on 200k events,
   plus autograd gradients; flat: the D=2 derivative stack), and times the
   kernel, the plain version and one PyTorch library call on the device
   (CUDA events around CUDA-graph replays; see ``time_ms``).
3. Drives the main path through the public entry points with every launch
   count set to 0 first: ``events_to_voxel(impl="matmul")``,
   ``events_to_image(impl="matmul")``, the analytic
   ``variance_objective.evaluate_gradient(impl="matmul")``, then
   ``optimize_contrast_jit(grid_search_init=True)`` and
   ``optimize_contrast(grid_search_init=True)`` on a 200k-event DAVIS240
   scene with a planted velocity, which both must recover within 4 px/s.
   Every kernel must have launched during this phase.

Prints a ``{"kernels": [...]}`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SENSOR = (180, 240)          # DAVIS240
B = 5
N_VOXEL = 1 << 21
N_SCENE = 200_000
VELOCITY = (60.0, -35.0)     # px/s, planted in the scene
SEED = 0
REPS = 20                    # timed graph replays (median)
CALLS = 10                   # calls captured in each graph
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS = 67e12            # H100 SXM, f32 outside the tensor cores
SRC = "event_utils_tpu_torch/csrc/scatter_kernels.cu"
REPLACES = {
    "voxel_scatter": "event_utils_tpu/ops/pallas_scatter.py:113",
    "flat_scatter": "event_utils_tpu/ops/pallas_scatter.py:496",
    "bilinear_scatter": "event_utils_tpu/ops/pallas_scatter.py:576",
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, torch):
    """Device time of one call of ``fn``, in ms.

    ``fn`` (output allocation, zeroing and launches) is captured CALLS
    times into one CUDA graph, so that the replay runs back to back on the
    card with no host gaps; the result is the median over REPS replays,
    each timed with CUDA events, divided by CALLS.
    """
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS)
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, ref, rel=1e-5):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  {name}: max|err| {err:.3e} of scale {scale:.3e}")
    if not (err <= rel * max(scale, 1.0)):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err} > {rel} * {scale})")
    return err


def voxel_events(rng):
    H, W = SENSOR
    xs = rng.integers(0, W, N_VOXEL).astype(np.int16)
    ys = rng.integers(0, H, N_VOXEL).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.5, N_VOXEL))
    ps = rng.choice(np.array([-1.0, 1.0]), N_VOXEL)
    return xs, ys, ts, ps


def planted_scene(rng):
    """Points moving with VELOCITY over a 0.25 s window, 200k events."""
    H, W = SENSOR
    n_pts, t_max = 400, 0.25
    vx, vy = VELOCITY
    px = rng.uniform(5 + max(0, -vx * t_max), W - 5 - max(0, vx * t_max),
                     n_pts)
    py = rng.uniform(5 + max(0, -vy * t_max), H - 5 - max(0, vy * t_max),
                     n_pts)
    pol = rng.choice(np.array([-1.0, 1.0]), n_pts)
    idx = rng.integers(0, n_pts, N_SCENE)
    ts = np.sort(rng.uniform(0.0, t_max, N_SCENE))
    xs = px[idx] + vx * ts + rng.normal(0, 0.2, N_SCENE)
    ys = py[idx] + vy * ts + rng.normal(0, 0.2, N_SCENE)
    return xs, ys, ts, pol[idx]


def kernel_phase(torch, cs, rng, records):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    H, W = SENSOR

    # ---- voxel -----------------------------------------------------------
    xs, ys, ts, ps = (torch.as_tensor(a, device=dev)
                      for a in voxel_events(rng))
    ts = ts.float()
    ps = ps.float()
    mask = torch.as_tensor(rng.random(N_VOXEL) > 0.2, device=dev)
    errs = []
    for label, kw in (("plain window", {}), ("masked", {"mask": mask}),
                      ("t1 override", {"t1": float(ts[N_VOXEL // 2])})):
        args = cs.voxel_inputs(xs, ys, ts, ps, B, SENSOR, **kw)
        errs.append(check_close(
            f"voxel_scatter ({label})", cs.voxel_scatter(*args, B, H, W),
            cs.voxel_scatter_plain(*args, B, H, W)))
    args = cs.voxel_inputs(xs, ys, ts, ps, B, SENSOR)
    t_norm, pv = args[2], args[3]
    b0 = torch.floor(t_norm)
    pix = args[1].long() * W + args[0].long()
    ids = torch.cat([b0.long().clamp(0, B - 1) * H * W + pix,
                     (b0.long() + 1).clamp(0, B - 1) * H * W + pix])
    vals = torch.cat([pv * (1 - (t_norm - b0)),
                      torch.where(b0 + 1 < B, pv * (t_norm - b0), 0.0)])
    lib = lambda: torch.zeros(B * H * W, device=dev).index_put_(
        (ids,), vals, accumulate=True)
    records["voxel_scatter"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: cs.voxel_scatter(*args, B, H, W), torch),
        plain_ms=time_ms(lambda: cs.voxel_scatter_plain(*args, B, H, W),
                         torch),
        library_ms=time_ms(lib, torch),
        bound=bound(N_VOXEL * 16 + B * H * W * 4, N_VOXEL * 8))

    # ---- bilinear ----------------------------------------------------------
    HP, WP = H + 1, W + 1
    n = N_SCENE
    x = torch.as_tensor(rng.uniform(-2, WP + 1, n), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(-2, HP + 1, n), dtype=torch.float32,
                        device=dev)
    errs = []
    w4 = torch.as_tensor(rng.uniform(-1, 1, (4, n)), dtype=torch.float32,
                         device=dev)
    for K in (1, 4):
        w = w4[:K].contiguous()
        errs.append(check_close(
            f"bilinear_scatter (K={K})", cs.bilinear_scatter(x, y, w, HP, WP),
            cs.bilinear_scatter_plain(x, y, w, HP, WP)))
    # autograd: kernel forward + gather backward vs autograd of index_add_
    from event_utils_tpu_torch.ops.scatter import bilinear_scatter as bs
    tgt = torch.as_tensor(rng.normal(size=(HP, WP)), dtype=torch.float32,
                          device=dev)
    grads = []
    for impl in ("matmul", "xla"):
        xg = x.clone().requires_grad_(True)
        yg = y.clone().requires_grad_(True)
        wg = w4[0].clone().requires_grad_(True)
        loss = (bs(xg, yg, wg, (HP, WP), impl=impl) * tgt).sum()
        grads.append(torch.autograd.grad(loss, (xg, yg, wg)))
    for name, gk, gp in zip("xyw", *grads):
        errs.append(check_close(f"bilinear grad d{name}", gk, gp, rel=1e-4))
    w1 = w4[:1].contiguous()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    taps_i, taps_v = [], []
    for oy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
        for ox, wx in ((0, 1 - (x - x0)), (1, x - x0)):
            ok = ((x0 + ox >= 0) & (x0 + ox < WP) & (y0 + oy >= 0)
                  & (y0 + oy < HP))
            taps_i.append(torch.where(ok, (y0 + oy) * WP + x0 + ox, 0).long())
            taps_v.append(torch.where(ok, w1[0] * wx * wy, 0.0))
    bi, bv = torch.cat(taps_i), torch.cat(taps_v)
    records["bilinear_scatter"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: cs.bilinear_scatter(x, y, w1, HP, WP), torch),
        plain_ms=time_ms(lambda: cs.bilinear_scatter_plain(x, y, w1, HP, WP),
                         torch),
        library_ms=time_ms(lambda: torch.zeros(HP * WP, device=dev)
                           .index_put_((bi,), bv, accumulate=True), torch),
        bound=bound(n * 12 + HP * WP * 4, n * 20))

    # ---- flat: the D=2 derivative stack of bilinear_scatter_derivative ----
    jx = torch.stack([-(torch.rand(n, device=dev) * 0.25),
                      torch.zeros(n, device=dev)])
    jy = jx.flip(0).contiguous()
    from event_utils_tpu_torch.ops.scatter import derivative_taps
    fi, fw = derivative_taps(x, y, jx, jy, w1[0], (HP, WP))
    fi = fi.to(torch.int32).contiguous()
    fw = fw.contiguous()
    nb = HP * WP
    D, m = fw.shape
    err = check_close("flat_scatter (D=2)", cs.flat_scatter(fi, fw, nb),
                      cs.flat_scatter_plain(fi, fw, nb))
    ok = (fi >= 0) & (fi < nb)
    lid = (torch.arange(D, device=dev)[:, None] * nb
           + torch.where(ok, fi, 0).long()[None, :]).reshape(-1)
    lv = torch.where(ok[None, :], fw, 0.0).reshape(-1)
    records["flat_scatter"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: cs.flat_scatter(fi, fw, nb), torch),
        plain_ms=time_ms(lambda: cs.flat_scatter_plain(fi, fw, nb), torch),
        library_ms=time_ms(lambda: torch.zeros(D * nb, device=dev)
                           .index_put_((lid,), lv, accumulate=True), torch),
        bound=bound(m * 4 + D * m * 4 + D * nb * 4, D * m))


def main_path(torch, P, rng):
    """The port's main path through its public entry points."""
    from event_utils_tpu_torch.contrast_max import (
        linvel_warp, optimize_contrast, optimize_contrast_jit,
        variance_objective)
    from event_utils_tpu_torch.representations import (events_to_image,
                                                       events_to_voxel)
    H, W = SENSOR
    xs, ys, ts, ps = voxel_events(rng)
    sx, sy, st, sp = planted_scene(rng)
    log(f"main path: {N_VOXEL} voxel events, {len(sx)}-event scene, "
        f"planted v={VELOCITY}")

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"  {label}: {time.perf_counter() - t0:.3f} s wall, "
            f"launches so far {P.ops.launch_counts()}")
        return out

    vox = timed("events_to_voxel(impl='matmul')", lambda: events_to_voxel(
        xs, ys, ts, ps, B, sensor_size=SENSOR, impl="matmul"))
    check_close("voxel grid vs the exact 'xla' route", vox, events_to_voxel(
        xs, ys, ts, ps, B, sensor_size=SENSOR, impl="xla"))
    img = timed("events_to_image(impl='matmul')", lambda: events_to_image(
        xs, ys, ps, sensor_size=SENSOR, impl="matmul"))
    check_close("event image vs the exact 'xla' route", img, events_to_image(
        xs, ys, ps, sensor_size=SENSOR, impl="xla"))
    grad = timed("evaluate_gradient(impl='matmul')",
                 lambda: variance_objective().evaluate_gradient(
                     np.array(VELOCITY), sx, sy, st, sp, linvel_warp(),
                     SENSOR, impl="matmul"))
    if not np.all(np.isfinite(grad)) or grad.shape != (2,):
        raise AssertionError(f"analytic gradient {grad}")

    v_jit = timed("optimize_contrast_jit", lambda: optimize_contrast_jit(
        sx, sy, st, sp, linvel_warp(), variance_objective(),
        img_size=SENSOR, grid_search_init=True))
    v_host = timed("optimize_contrast", lambda: optimize_contrast(
        sx, sy, st, sp, linvel_warp(), variance_objective(), blur_sigma=1.0,
        img_size=SENSOR, grid_search_init=True))
    for label, v in (("optimize_contrast_jit", v_jit),
                     ("optimize_contrast", v_host)):
        v = np.asarray(v, np.float64)
        err = np.abs(v - np.array(VELOCITY)).max()
        log(f"  {label}: v={v.tolist()} |err|max={err:.3f} px/s")
        if not err <= 4.0:
            raise AssertionError(f"{label} missed the planted velocity")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import event_utils_tpu_torch as P
    from event_utils_tpu_torch.ops import build
    from event_utils_tpu_torch.ops import cuda_scatter as cs

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_log})")

    rng = np.random.default_rng(SEED)
    records = {}
    kernel_phase(torch, cs, rng, records)
    torch.cuda.synchronize()

    cs.reset_launch_counts()
    main_path(torch, P, rng)
    torch.cuda.synchronize()
    launches = cs.launch_counts()
    log(f"main-path launches: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = rec["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
