#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``event_utils_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``event_utils_tpu_torch/csrc`` and prints the build time.
2. Holds each kernel against its plain PyTorch version at the main path's
   shapes (voxel: 2^21 time-sorted events, B=5, 180x240, also masked and
   with a t1 override; per-tile voxel: the same stream at 720p bucketed
   into 80 (96, 128) tiles, the same three cases; bilinear: K=1 and K=4 at
   181x241 on 200k events, plus autograd gradients, and the patch atlas
   of one batched ``grid_cmax_batched`` loss evaluation, 5.5M warped
   events; flat: the D=2 derivative stack), and times the kernel, the
   plain version and one PyTorch library call on the device (CUDA events
   around CUDA-graph replays; see ``time_ms``).
3. Drives the main path through the public entry points with every launch
   count set to 0 first: ``events_to_voxel(impl="matmul")``,
   ``events_to_image(impl="matmul")``, the analytic
   ``variance_objective.evaluate_gradient(impl="matmul")``, then
   ``optimize_contrast_jit(grid_search_init=True)`` and
   ``optimize_contrast(grid_search_init=True)`` on a 200k-event DAVIS240
   scene with a planted velocity, which both must recover within 4 px/s.
   Then the ROI-bucketed path: ``events_to_voxel(impl="tiled")`` and
   ``events_to_voxel_tiled`` at VGA and 720p on 2^21 events (each against
   the exact route), ``grid_cmax_batched`` on the rotating bench scene
   (all-ROI median flow error at most 4.5 px/s; again with
   ``pyramid="auto"``), and the host loop ``grid_cmax`` on one 40x60
   corner of it. Every kernel must have launched during this phase.
4. Times the tiled route and its host bucketing alone, warm, and prints
   the bucketing's share of the route's wall.

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
TILED_SENSORS = {"VGA": (480, 640), "720p": (720, 1280)}
TILE = (96, 128)
ROT_SENSOR = (180, 240)      # the rotating bench scene
ROT_ROI = (20, 20)
ROT_EVENTS = 200_000
ROT_OMEGA = 1.2              # rad/s about the sensor centre
ROT_CAPACITY = 2048
ROT_MAXITER = 30
FLOW_ERR_LIMIT = 4.5         # px/s, all-ROI median against the field
TILED_REPS = 5               # warm calls timed per route for the share
SRC = "event_utils_tpu_torch/csrc/scatter_kernels.cu"
REPLACES = {
    "voxel_scatter": "event_utils_tpu/ops/pallas_scatter.py:113",
    "voxel_tiles_scatter": "event_utils_tpu/ops/pallas_scatter.py:455",
    "flat_scatter": "event_utils_tpu/ops/pallas_scatter.py:496",
    "bilinear_scatter": "event_utils_tpu/ops/pallas_scatter.py:576",
}


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:6.1f} s]", *a, flush=True)


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


def bilinear_bound(x, y, K: int, H: int, W: int):
    """Bound of one (K, H, W) bilinear splat on this run's coordinates: x
    and y are read for every event, the K weights (and their taps) only
    for events with a tap inside the image; the kernel drops the others
    before it reads their weights."""
    x0, y0 = x.floor(), y.floor()
    live = int(((x0 >= -1) & (x0 < W) & (y0 >= -1) & (y0 < H)).sum())
    return bound(len(x) * 8 + live * 4 * K + K * H * W * 4, live * K * 20)


def check_close(name, got, ref, rel=1e-5):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  {name}: max|err| {err:.3e} of scale {scale:.3e}")
    if not (err <= rel * max(scale, 1.0)):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err} > {rel} * {scale})")
    return err


def voxel_events(rng, sensor=SENSOR):
    """N_VOXEL uniform, time-sorted events over ``sensor``."""
    H, W = sensor
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


def rotating_scene(seed=0):
    """The bench's rotating scene (180x240, 400 points turning at
    ROT_OMEGA about the centre for 0.2 s, 200k events): the flow varies
    across the sensor and is ~constant within each 20x20 ROI."""
    rng = np.random.default_rng(seed)
    H, W = ROT_SENSOR
    n_pts = 400
    px = rng.uniform(10, W - 10, n_pts)
    py = rng.uniform(10, H - 10, n_pts)
    pol = rng.choice([-1.0, 1.0], n_pts)
    cx, cy = W / 2, H / 2
    idx = rng.integers(0, n_pts, ROT_EVENTS)
    ts = np.sort(rng.uniform(0, 0.2, ROT_EVENTS))
    ang = ROT_OMEGA * ts
    rx = px[idx] - cx
    ry = py[idx] - cy
    xs = (cx + np.cos(ang) * rx - np.sin(ang) * ry
          + rng.normal(0, 0.2, ROT_EVENTS))
    ys = (cy + np.sin(ang) * rx + np.cos(ang) * ry
          + rng.normal(0, 0.2, ROT_EVENTS))
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return xs[keep], ys[keep], ts[keep], pol[idx][keep]


def flow_error(params, rois, valid):
    """All-valid-ROI median |v - v_true| (px/s) against the rotation field
    at each ROI centre."""
    p, r, v = (a.cpu().numpy() for a in (params, rois, valid))
    cx, cy = ROT_SENSOR[1] / 2, ROT_SENSOR[0] / 2
    gt = np.stack([-ROT_OMEGA * (r[:, 0] + ROT_ROI[0] / 2 - cy),
                   ROT_OMEGA * (r[:, 1] + ROT_ROI[1] / 2 - cx)], 1)
    return float(np.median(np.linalg.norm(p - gt, axis=1)[v])), int(v.sum())


def tiles_phase(torch, cs, rng, records):
    """The per-tile voxel kernel at 720p: 2^21 events bucketed into
    80 (96, 128) tiles by the port's bucket_events_by_roi."""
    from event_utils_tpu_torch.contrast_max import bucket_events_by_roi
    dev = torch.device("cuda")
    H, W = TILED_SENSORS["720p"]
    th, tw = TILE
    ny, nx = -(-H // th), -(-W // tw)
    xs, ys, ts, ps = voxel_events(rng, (H, W))
    bx, by, bt, bp, bmask, org, _ = bucket_events_by_roi(
        xs, ys, ts, ps, (ny * th, nx * tw), TILE, capacity_cap=None,
        device=dev)
    T, cap = bx.shape
    log(f"per-tile voxel: T={T} tiles, capacity {cap}, {N_VOXEL} events")
    lx = bx.int() - org[:, 1:2].int()
    ly = by.int() - org[:, 0:1].int()
    keep = torch.as_tensor(rng.random((T, cap)) > 0.2, device=dev).float()
    errs = []
    for label, mask, t1 in (("plain window", bmask, ts[-1]),
                            ("masked", bmask * keep, ts[-1]),
                            ("t1 override", bmask, ts[N_VOXEL // 2])):
        args = cs.voxel_tiles_inputs(lx, ly, bt, bp, B, TILE, ts[0], t1,
                                     mask=mask)
        errs.append(check_close(
            f"voxel_tiles_scatter ({label})",
            cs.voxel_tiles_scatter(*args, B, th, tw),
            cs.voxel_tiles_scatter_plain(*args, B, th, tw)))
    args = cs.voxel_tiles_inputs(lx, ly, bt, bp, B, TILE, ts[0], ts[-1],
                                 mask=bmask)
    t_norm, pv = args[2], args[3]
    b0 = torch.floor(t_norm)
    base = (torch.arange(T, device=dev)[:, None] * B * th * tw
            + args[1].long() * tw + args[0].long())
    ids, vals = [], []
    for b, wt in ((b0, pv * (1 - (t_norm - b0))), (b0 + 1, pv * (t_norm - b0))):
        # dead taps are left out, as for the bilinear library call
        ok = (b >= 0) & (b < B) & (pv != 0)
        ids.append((base + b.long() * th * tw)[ok])
        vals.append(wt[ok])
    ids, vals = torch.cat(ids), torch.cat(vals)
    # the kernel reads bp (4 B) of every slot, and bx, by, t_norm (12 B)
    # only of the live ones; dead slots hold the pad sentinel bp = 0
    live = int((pv != 0).sum())
    log(f"  {live} live slots of {T * cap}")
    records["voxel_tiles_scatter"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: cs.voxel_tiles_scatter(*args, B, th, tw), torch),
        plain_ms=time_ms(lambda: cs.voxel_tiles_scatter_plain(*args, B, th,
                                                              tw), torch),
        library_ms=time_ms(lambda: torch.zeros(T * B * th * tw, device=dev)
                           .index_put_((ids,), vals, accumulate=True), torch),
        bound=bound(T * cap * 4 + live * 12 + T * B * th * tw * 4, live * 8))


def bilinear_times(torch, cs, x, y, w1, H, W):
    """Kernel, plain and ``index_put_`` times and the bound of one K=1
    bilinear splat of ``w1`` (1, N) at (x, y) into (H, W); the kernel is
    also held against its plain version on these inputs."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    taps_i, taps_v = [], []
    for oy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
        for ox, wx in ((0, 1 - (x - x0)), (1, x - x0)):
            ok = ((x0 + ox >= 0) & (x0 + ox < W) & (y0 + oy >= 0)
                  & (y0 + oy < H))
            # taps outside the image are left out: sent to one id with
            # weight 0 they would serialise index_put_'s duplicate runs
            taps_i.append(((y0 + oy) * W + x0 + ox)[ok].long())
            taps_v.append((w1[0] * wx * wy)[ok])
    bi, bv = torch.cat(taps_i), torch.cat(taps_v)
    shape = f"K=1, {len(x)} events into {H}x{W}"
    rec = dict(
        shape=shape,
        max_abs_err=check_close(f"bilinear_scatter ({shape})",
                                cs.bilinear_scatter(x, y, w1, H, W),
                                cs.bilinear_scatter_plain(x, y, w1, H, W)),
        ms=time_ms(lambda: cs.bilinear_scatter(x, y, w1, H, W), torch),
        plain_ms=time_ms(lambda: cs.bilinear_scatter_plain(x, y, w1, H, W),
                         torch),
        library_ms=time_ms(lambda: torch.zeros(H * W, device=x.device)
                           .index_put_((bi,), bv, accumulate=True), torch),
        bound=bilinear_bound(x, y, 1, H, W))
    log(f"  timed: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
        f"ms, index_put_ {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound'][0]:.5f} ms")
    return rec


def patch_atlas_inputs(torch):
    """The bilinear kernel's inputs in one evaluation of the batched patch
    loss of ``grid_cmax_batched``'s first grid-search step: the rotating
    scene bucketed into 108 ROIs at capacity 2048, 25 velocity samples per
    ROI, every patch splatted into one atlas. Returns (x, y, w, H, W),
    captured at the loss's call of ``bilinear_matmul``."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.contrast_max import linvel_warp
    dev = torch.device("cuda")
    H, W = ROT_SENSOR
    bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
        *rotating_scene(), ROT_SENSOR, ROT_ROI, ROT_CAPACITY, device=dev)
    R = bx.shape[0]
    loss = ec.make_patch_loss(linvel_warp(), ROT_ROI, "variance",
                              full_pixels=(H + 1) * (W + 1))
    g = torch.linspace(-150.0, 150.0, 5, device=dev)
    params = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
    params = params.reshape(1, 25, 2).expand(R, 25, 2)
    seen = []
    splat = ec.bilinear_matmul

    def capture(x, y, w, shape, **kw):
        seen.append((x, y, w, shape))
        return splat(x, y, w, shape, **kw)

    ec.bilinear_matmul = capture
    try:
        with torch.no_grad():
            loss(params, bx, by, bt, bp, bm, org.float())
    finally:
        ec.bilinear_matmul = splat
    x, y, w, (AH, AW) = seen[0]
    log(f"patch atlas: {R} ROIs x 25 samples, {x.numel()} warped events "
        f"into {AH}x{AW}")
    return (x.float().contiguous(), y.float().contiguous(),
            w.float().contiguous(), AH, AW)


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

    tiles_phase(torch, cs, rng, records)

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
    rec = bilinear_times(torch, cs, x, y, w4[:1].contiguous(), HP, WP)
    # the patch atlas of grid_cmax_batched's loss, the path's largest launch
    atlas = bilinear_times(torch, cs, *patch_atlas_inputs(torch))
    rec["cases"] = [
        dict({k: c[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                "max_abs_err")}, bound_ms=c["bound"][0])
        for c in (rec, atlas)]
    rec["max_abs_err"] = max(errs + [rec["max_abs_err"],
                                     atlas["max_abs_err"]])
    records["bilinear_scatter"] = rec

    # ---- flat: the D=2 derivative stack of bilinear_scatter_derivative ----
    jx = torch.stack([-(torch.rand(n, device=dev) * 0.25),
                      torch.zeros(n, device=dev)])
    jy = jx.flip(0).contiguous()
    from event_utils_tpu_torch.ops.scatter import derivative_taps
    fi, fw = derivative_taps(x, y, jx, jy, w4[0], (HP, WP))
    fi = fi.to(torch.int32).contiguous()
    fw = fw.contiguous()
    nb = HP * WP
    D, m = fw.shape
    err = check_close("flat_scatter (D=2)", cs.flat_scatter(fi, fw, nb),
                      cs.flat_scatter_plain(fi, fw, nb))
    # dropped ids are left out, as for the bilinear library call
    ok = ((fi >= 0) & (fi < nb))[None, :].expand(D, m)
    lid = (torch.arange(D, device=dev)[:, None] * nb + fi.long()[None, :])[ok]
    lv = fw[ok]
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
    roi_path(torch, P, rng, timed)


def roi_path(torch, P, rng, timed):
    """The ROI-bucketed path: tiled voxel grids at VGA and 720p, then the
    per-ROI flow solvers on the rotating bench scene."""
    from event_utils_tpu_torch.contrast_max import grid_cmax, grid_cmax_batched
    from event_utils_tpu_torch.representations import (events_to_voxel,
                                                       events_to_voxel_tiled)
    for name, (H, W) in TILED_SENSORS.items():
        xs, ys, ts, ps = voxel_events(rng, (H, W))
        exact = events_to_voxel(xs, ys, ts, ps, B, sensor_size=(H, W),
                                impl="xla")
        grids = {
            "impl='tiled'": timed(
                f"events_to_voxel(impl='tiled') {name} {(H, W)}",
                lambda: events_to_voxel(xs, ys, ts, ps, B, sensor_size=(H, W),
                                        impl="tiled")),
            "events_to_voxel_tiled": timed(
                f"events_to_voxel_tiled {name}",
                lambda: events_to_voxel_tiled(xs, ys, ts, ps, B, (H, W)))}
        for label, grid in grids.items():
            check_close(f"{label} {name} vs the exact 'xla' route", grid,
                        exact)

    sx, sy, st, sp = rotating_scene()
    log(f"  rotating scene: {len(sx)} events, omega={ROT_OMEGA} rad/s, "
        f"ROI {ROT_ROI}, capacity {ROT_CAPACITY}, maxiter {ROT_MAXITER}")
    kw = dict(roi_size=ROT_ROI, img_size=ROT_SENSOR, maxiter=ROT_MAXITER,
              capacity=ROT_CAPACITY)
    for label, extra in (("grid_cmax_batched", {}),
                         ("grid_cmax_batched(pyramid='auto')",
                          {"pyramid": "auto"})):
        params, rois, f_evals, valid = timed(
            label, lambda: grid_cmax_batched(sx, sy, st, sp, **kw, **extra))
        if not bool(torch.isfinite(params).all()):
            raise AssertionError(f"{label}: non-finite params")
        err, n_valid = flow_error(params, rois, valid)
        log(f"  {label}: all-ROI median flow error {err:.3f} px/s over "
            f"{n_valid} valid ROIs (limit {FLOW_ERR_LIMIT} for the plain "
            f"solve)")
        if not extra and not err <= FLOW_ERR_LIMIT:
            raise AssertionError(f"{label}: median flow error {err} px/s")

    corner = (sx < 60) & (sy < 40)
    params, rois, _ = timed("grid_cmax (host loop, one 40x60 corner)",
                            lambda: grid_cmax(sx[corner], sy[corner],
                                              st[corner], sp[corner],
                                              roi_size=ROT_ROI,
                                              img_size=ROT_SENSOR))
    log(f"  grid_cmax: {len(params)} ROIs, params "
        f"{np.round(np.array(params), 3).tolist()}")
    if len(params) != 6 or not all(np.isfinite(p).all() for p in params):
        raise AssertionError(f"grid_cmax: {params} over {rois}")


def bucketing_share(torch, rng):
    """Share of the tiled voxel route's wall that the host bucketing takes:
    warm medians over TILED_REPS calls of each, alternated, at VGA and
    720p (run after the launch counts are read)."""
    from event_utils_tpu_torch.contrast_max import bucket_events_by_roi
    from event_utils_tpu_torch.representations import events_to_voxel_tiled
    dev = torch.device("cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, (H, W) in TILED_SENSORS.items():
        xs, ys, ts, ps = voxel_events(rng, (H, W))
        ny, nx = -(-H // TILE[0]), -(-W // TILE[1])
        route = lambda: events_to_voxel_tiled(xs, ys, ts, ps, B, (H, W),
                                              device=dev)
        bucket = lambda: bucket_events_by_roi(
            xs, ys, ts, ps, (ny * TILE[0], nx * TILE[1]), TILE,
            capacity_cap=None, device=dev)
        route(), bucket()
        walls, buckets = [], []
        for _ in range(TILED_REPS):
            walls.append(wall(route))
            buckets.append(wall(bucket))
        w, b = float(np.median(walls)), float(np.median(buckets))
        log(f"  tiled route {name}: wall {w:.4f} s, host bucketing (with "
            f"its copies to the card) {b:.4f} s, share {b / w:.3f} "
            f"(medians of {TILED_REPS}, warm)")


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
    bucketing_share(torch, rng)

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = rec["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": rec["library_ms"],
            **({"cases": rec["cases"]} if "cases" in rec else {})})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
