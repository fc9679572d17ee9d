#!/usr/bin/env python3
"""Measure what the routes of the scatter kernels cost on the card, and
which launch parameters are fastest.

    python3 scripts/tune_scatter_routes.py [--parts 6,7,8] [--out r.jsonl]
        [--cases chunk,6x8]

The thresholds in ``ops/cuda_scatter.py`` (``PRIVATE_*``,
``private_blocks``, ``PATCH_MIN_PATCHES``, ``VECTOR_*``) and the
launch parameters fixed in ``csrc/scatter_kernels.cu`` come from this
script's output. The package
ships one configuration of each kernel; the others that are measured here
(and the probe of part 1) are built from ``scripts/tune_scatter_variants.cu``.
It prints the card's name and power limit, then one JSON line per
measurement (with ``--out``, also written to that file):

1. What holds the small splat back, at K=1, 200k events into 181x241, on
   uniform coordinates, on the planted scene as recorded and on the planted
   scene warped onto its 400 tracks: the ``torch.zeros`` alone; the direct
   kernel with and without it; the same kernel with its atomics replaced
   by a register sum that each thread stores once (``probe``, not part of
   the package): what loads, arithmetic and the launch cost without any
   atomic.
2. The whole-image splat on every route over event counts from 512 to
   200k, into 181x241 and 41x61: direct, one block (block size, bulk or
   per-thread store), G private blocks (G, bulk reduction or per-thread
   atomics that skip zeros).
3. The patch kernel at one batched loss evaluation of the ROI solver
   (K=1 and K=4): block size, bulk or per-thread store, channels per
   block; then, from one descent step (one sample per ROI) up to the full
   evaluation, the patch kernel against the direct patch kernel and the
   atlas route.
4. The per-tile voxel kernel at 720p and VGA: direct, the cluster variant
   (taps through distributed shared memory) and the replicated variant
   (every block reads all slots) with and without a cluster launch, block
   size, bulk or per-thread store.
5. The host's time per eager call of the whole-image splat on each route
   (200 calls, no synchronisation): what a host-bound solver pays.
6. What holds the voxel and flat kernels back. The reductions and atomics
   in the SASS of both built libraries, by kernel (``cuobjdump -sass``).
   The voxel kernel on 2^21 events into (5, 180, 240) and the flat kernel
   on the D=2 derivative stack of 200k events: ``torch.zeros`` alone, the
   kernel with and without it, the kernel with its atomics replaced by a
   register sum. The L2's rate of reductions: 2^21 threads that each send
   one scalar, two scalars half a buffer apart, two adjacent scalars, one
   ``float2`` or one ``float4`` to a random place of an 0.86 MB and a 2 MB
   buffer. ``atomicAdd`` on shared memory, int against float.
7. The voxel kernel's routes over event counts from 4096 to 2^21 at
   180x240 (5 and 9 bins), VGA and 720p: direct, vector, and the variant
   with one accumulator (a ``float2`` for even first bins, two scalars for
   odd ones).
8. The flat kernel's routes: the D=2 derivative stack over id counts from
   4096 to 800k, the D=1 event image up to 2^21 ids, D = 3, 4, 5, 8 at
   200k ids, D=2 into 480x640 buckets; direct and vector, and the variants
   with one thread per (row, id) element and with ids loaded ahead.
9. The batched private kernel against the cluster variant (private
   copies summed across a thread-block cluster through distributed shared
   memory, ``cluster_splat_body`` in the variants' source): how many
   clusters of each size (1-16 CTAs, non-portable past 8) the card holds
   at once for a 181x241 image and a (64, 128) patch; then the batched
   private route at the main path's shapes (a single image of 200k uniform
   and warped events, a grid level of 25 x 200k, loss chunks of 2^24 // N
   samples of N events (83 x 200k, 129 x 130k, 167 x 100k), the
   landscape's 400 x 15k, a stream grid level of 25 x 20k, 2700 ROI rows
   of 2048 slots, 25 x 200k events all on one pixel, 65535 and 65536
   samples of 4 events into 6x8) as shipped, with the blocks that fill one
   wave and, where one block a sample leaves SMs idle, with 1-6 blocks a
   sample in waves (``private_blocks`` comes from these rows); against the
   cluster variant over cluster sizes G and clusters a sample, with and
   without a warp's lanes grouped by pixel; and the few-patch variant (one
   cluster per patch, grouped or not: a descent step of 108 patches at
   K = 1 and 4, 1024 slots a patch, all slots on one pixel) against the
   direct and patch kernels, over G; and each kernel launched with no
   slots (its fixed cost). ``--cases`` keeps the image cases whose label
   holds one of its words and skips the patches.
10. The few-patch route over whole ROI solves: every splat of fewer than
   768 patches that ``grid_cmax_batched`` makes on the rotating scene
   (descent and BFGS; and a 20,000-event window at 1024 slots a patch, as
   ``stream_flow`` cuts them) is kept, and about 40 of them, spread over the
   solve, are timed on the direct route and on the grouped cluster variant
   (G = 2): the mean device ms a call on each.

11. Few events and K = 4 (``--cases`` picks its sections: ``floor``,
   ``few``, ``sweep``, ``many``). floor: an empty kernel
   (``torch.cuda._sleep(0)``) and a one-float fill, the floor of one graph
   node. few: what a splat of 512-2,048 events into 181x241 costs beside
   its work (the memset alone, the direct kernel without it, the band
   variant with no events) and the host's wall per eager call on the
   direct route and on the band variant, which spares the memset. sweep:
   event counts from 512 to 131072, images 21x21, 181x241, 240x256 and
   480x640, K = 1 and 4, S = 1 and 25 (per-sample weights): the direct,
   private and vector routes as shipped (vector held per pixel within the
   smoke's ``splat_limits``) against the row-band variant (``band_variant``:
   each block owns rows of the uninitialised output) over its rows a band
   (1 to all rows) and, at a few shapes, its block size (256, 512, 1024)
   and the band in shared memory (stored by every thread or by one bulk
   copy a channel). many: K = 4 at 200k events into 181x241 (the timestamp
   image, S = 1; zhu's grid level, S = 25; a loss chunk, S = 83) on the
   direct and vector routes as shipped, the vector kernels in launches of
   1 to S samples, and one private plane per (sample, channel)
   (``plane_variant``). ``VECTOR_MIN_SAVED_BILINEAR`` comes from these rows.
12. The batched voxel routes (``PRIVATE_MIN_GRID_BYTES`` comes from
   these rows): at the paths' shapes
   (DAVIS240 in 104 windows of 20,000 and 8 of 2^18; the trainers' split
   rows, ``fit``'s 8 x 32,768 at 184x240, the flow batch's 8 x 65,536
   and 96 E2VID windows of 12,288 at 128x128) and a sweep of rows and
   events around them: the memset of the grids alone, the direct, vector
   and private routes as shipped, the private kernel over its layouts
   (one or both signs' planes a block, bands of 1/1 to 1/4 of the rows,
   256 to 1024 threads; at the paths' shapes also launched with no events:
   zeroing and storing alone), and, for more than 16 rows, the direct
   kernel launched on chunks of rows whose grids are zeroed just before
   (so that they stay in the L2). At the paths' shapes the private
   kernel's knobs (``voxel_private_variant``): 4 or 8 slots a thread a
   pass, ``t_norm`` read as ``float4``, per-thread stores instead of the
   bulk copy, and no store at all. Around ``PRIVATE_MIN_GRID_BYTES``: the
   three routes as shipped at 24-80 DAVIS240 rows and 40-80 split rows at
   128x128, of 4,096 to 65,536 events. ``--cases`` picks its sections:
   ``paths``, ``sweep``, ``knobs``, ``rule``.

Rows marked "as shipped" time the package's own kernel through its
wrapper; the others time a variant (the variant with the shipped parameters
keeps its run-time arguments and so runs a little slower than the package's
kernel, in which they are constants). Every variant is first held against
the plain version (1e-5 of the output scale); a variant that disagrees is
reported and the script exits non-zero at its end. Times are
``chip_smoke.time_ms`` (CUDA events around CUDA-graph replays of 10 calls,
median of 20). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS_SOURCE = os.path.join(ROOT, "scripts", "tune_scatter_variants.cu")

failed = []
lines = []


def emit(**kw):
    lines.append(json.dumps(kw))
    print(lines[-1], flush=True)


def build_variants(build):
    """Compile VARIANTS_SOURCE (the slower variants and the no-atomics
    probe) into a temporary directory and load it."""
    lib = os.path.join(tempfile.mkdtemp(prefix="variants_"),
                       "libvariants.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           VARIANTS_SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {VARIANTS_SOURCE}:\n"
                           f"{proc.stderr[-6000:]}")
    # registers, shared memory and spills of the variants' kernels
    print("\n".join(line for line in proc.stderr.splitlines()
                    if "ptxas info" in line or "spill" in line), flush=True)
    dll = ctypes.CDLL(lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, argtypes in {
            "probe": [P, P, P, L, I, I, P, I, P],
            "patches_variant": [P, P, P, L, L, I, I, I, I, P, I, I, P],
            "private_variant": [P, P, P, L, I, I, I, P, I, I, I, P],
            "tiles_variant": [P, P, P, P, L, L, I, I, I, P, I, I, I, P],
            "voxel_probe": [P, P, P, P, L, I, I, I, P, P],
            "flat_rows": [P, P, L, I, L, P, I, P],
            "flat_ahead": [P, P, L, I, L, P, P],
            "voxel_single": [P, P, P, P, L, I, I, I, I, P, P, P],
            "red_probe": [P, L, L, I, P],
            "shared_atomic_probe": [P, I, I, I, I, P],
            "cluster_wide": [P, P, P, L, L, L, I, I, I, P, I, I, I, P],
            "patches_cluster": [P, P, P, L, L, I, I, I, P, I, I, P],
            "cluster_wide_occupancy": [I, I, I, I, P],
            "band_variant": [P, P, P, L, L, L, I, I, I, I, I, I, P, P],
            "plane_variant": [P, P, P, L, L, L, I, I, I, P, P],
            "voxel_private_variant": [P, P, P, P, L, L, I, I, I, I, I, I, I,
                                      I, I, P, P],
    }.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = I
    return dll


def sass_reductions(build, lib_path):
    """Count the reduction and atomic instructions in each kernel of a
    built library (``cuobjdump -sass``): ``{kernel: {mnemonic: count}}``."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # the mangled name from the kernel's own name on, template
            # arguments included (flat_vector_kernelILi2EE...)
            kernel = line.split("Function :")[1].strip()
            short = re.search(r"\d([a-z][a-z_]*_kernel\w{0,8})", kernel)
            kernel = short.group(1) if short else kernel
            continue
        m = re.search(r"\b((?:REDG?|ATOM[GS]?)\.[A-Za-z0-9_.]+)", line)
        if m and kernel:
            per = found.setdefault(kernel, {})
            per[m.group(1)] = per.get(m.group(1), 0) + 1
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--parts", default="1,2,3,4,5,6,7,8,9,10,11,12",
                        help="comma-separated parts to run (default: all)")
    parser.add_argument("--cases", default="",
                        help="part 9: only the image cases whose label holds "
                        "one of these comma-separated words (no patches); "
                        "part 11: only these sections (floor, few, sweep, "
                        "many); part 12: paths, sweep, knobs, rule")
    opts = parser.parse_args()
    try:
        return run({int(k) for k in opts.parts.split(",")},
                   [c for c in opts.cases.split(",") if c])
    finally:
        if opts.out:
            with open(opts.out, "w") as f:
                f.write("\n".join(lines) + "\n")


def run(parts, only=()) -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from event_utils_tpu_torch.ops import build, cuda_scatter as cs

    dev = torch.device("cuda")
    f32 = torch.float32
    print(chip_smoke.card_line(), flush=True)
    lib = build.library()
    # registers and shared memory per kernel, when this process built them
    print(build.build_log.get("scatter_kernels", {}).get("ptxas", ""),
          flush=True)
    vlib = build_variants(build)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    T = lambda fn, **kw: chip_smoke.time_ms(fn, torch, **kw)

    def agrees(what, got, ref):
        try:
            chip_smoke.check_close(what, got, ref)
            return True
        except AssertionError as e:
            failed.append(str(e))
            return False

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=dev)

    # ---- coordinate sets, 200k events into 181x241 ----------------------
    H, W = chip_smoke.SENSOR[0] + 1, chip_smoke.SENSOR[1] + 1
    n = chip_smoke.N_SCENE
    rng = np.random.default_rng(chip_smoke.SEED)
    sx, sy, st, sp = chip_smoke.planted_scene(rng)
    vx, vy = chip_smoke.VELOCITY
    coords = {
        "uniform": (t(rng.uniform(-2, W + 1, n)), t(rng.uniform(-2, H + 1, n)),
                    t(rng.uniform(-1, 1, n))[None]),
        "scene": (t(sx), t(sy), t(sp)[None]),
        "scene_warped": (t(sx - vx * st), t(sy - vy * st), t(sp)[None]),
    }

    def direct_raw(x, y, w, h, wd, out):
        build.check(lib.bilinear_scatter_batched(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), 1, x.shape[0], 0,
            w.shape[0], h, wd, out.data_ptr(), stream()), "direct")
        return out

    def private(x, y, w, h, wd, blocks, threads, bulk):
        K = w.shape[0]
        alloc = torch.empty if blocks == 1 else torch.zeros
        out = alloc((K, h, wd), dtype=f32, device=dev)
        build.check(vlib.private_variant(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), x.shape[0], K, h, wd,
            out.data_ptr(), blocks, threads, bulk, stream()), "private")
        return out

    # ---- 1. what holds the small splat back -----------------------------
    if 1 in parts:
        emit(part=1, what="torch.zeros((1, 181, 241)) alone",
             ms=T(lambda: torch.zeros((1, H, W), dtype=f32, device=dev)))
        scratch = torch.empty((1, H, W), dtype=f32, device=dev)
        blocks = -(-n // 256)
        sums = torch.empty(blocks * 256, dtype=f32, device=dev)
        for name, (x, y, w) in coords.items():
            emit(part=1, coords=name, what="zeros + direct kernel",
                 ms=T(lambda: cs.bilinear_scatter(x, y, w, H, W,
                                                  route="direct")))
            emit(part=1, coords=name, what="direct kernel alone (no memset)",
                 ms=T(lambda: direct_raw(x, y, w, H, W, scratch)))
            emit(part=1, coords=name,
                 what="probe: same kernel, atomics replaced by a register sum",
                 ms=T(lambda: build.check(vlib.probe(
                     x.data_ptr(), y.data_ptr(), w.data_ptr(), n, H, W,
                     sums.data_ptr(), blocks, stream()), "probe")))
        x, y, w = coords["uniform"]
        emit(part=1, what="probe on one event, one block (launch floor)",
             ms=T(lambda: build.check(vlib.probe(
                 x.data_ptr(), y.data_ptr(), w.data_ptr(), 1, H, W,
                 sums.data_ptr(), 1, stream()), "probe")))

    # ---- 2. whole-image routes -------------------------------------------
    if 2 in parts:
        for (h, wd), sets in (((H, W), ("uniform", "scene_warped")),
                              ((41, 61), ("uniform",))):
            for name in sets:
                x0, y0, w0 = coords[name]
                if (h, wd) != (H, W):
                    x0, y0 = x0 % wd, y0 % h
                for m in (512, 2048, 8192, 32768, 65536, 131072, n):
                    x, y, w = (x0[:m].contiguous(), y0[:m].contiguous(),
                               w0[:, :m].contiguous())
                    ref = cs.bilinear_scatter_plain(x, y, w, h, wd)
                    tag = dict(part=2, image=[h, wd], coords=name, events=m)
                    emit(**tag, route="direct", ms=T(
                        lambda: cs.bilinear_scatter(x, y, w, h, wd,
                                                    route="direct")))
                    emit(**tag, route="private, as shipped", ms=T(
                        lambda: cs.bilinear_scatter(x, y, w, h, wd,
                                                    route="private")))
                    variants = []
                    if m <= 32768:
                        variants += [(1, th, b) for th in (256, 1024)
                                     for b in (1, 0)]
                    if m >= 8192:
                        variants += [(g, 1024, b)
                                     for g in (8, 16, 32, 64, 96, 132)
                                     for b in (1, 0)]
                        variants += [(64, 512, 0), (132, 512, 0)]
                    for g, th, b in variants:
                        ok = agrees(f"private G={g} threads={th} bulk={b} "
                                    f"{tag}",
                                    private(x, y, w, h, wd, g, th, b), ref)
                        emit(**tag, route="private", blocks=g, threads=th,
                             bulk=b, ok=ok,
                             ms=T(lambda: private(x, y, w, h, wd, g, th, b)))

    # ---- 3. the patch kernel ---------------------------------------------
    if 3 in parts:
        def patches(x, y, w, P, C, PH, PW, kb, threads, bulk):
            K = w.shape[0]
            out = torch.empty((K, P, PH, PW), dtype=f32, device=dev)
            build.check(vlib.patches_variant(
                x.data_ptr(), y.data_ptr(), w.data_ptr(), P, C, K, kb, PH, PW,
                out.data_ptr(), threads, bulk, stream()), "patches")
            return out

        for objective in ("variance", "zhu"):
            x, y, w, P, C, PH, PW = chip_smoke.patch_loss_inputs(
                torch, objective)
            K = w.shape[0]
            ref = cs.bilinear_patches_scatter_plain(x, y, w, P, C, PH, PW)
            tag = dict(part=3, K=K, patches=P, slots=C, patch=[PH, PW])
            emit(**tag, route="atlas (direct kernel + un-tiling)",
                 ms=T(chip_smoke.atlas_route(torch, cs, x, y, w, P, C, PH, PW),
                      calls=2, reps=5))
            emit(**tag, route="patch, as shipped", ms=T(
                lambda: cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW,
                                                    route="patch")))
            for kb in ((1,) if K == 1 else (4, 2, 1)):
                for th in (128, 256, 512, 1024):
                    for b in (1, 0):
                        ok = agrees(f"patches kb={kb} threads={th} bulk={b} "
                                    f"{tag}",
                                    patches(x, y, w, P, C, PH, PW, kb, th, b),
                                    ref)
                        emit(**tag, route="patch", channels_per_block=kb,
                             threads=th, bulk=b, ok=ok, ms=T(
                                 lambda: patches(x, y, w, P, C, PH, PW, kb, th,
                                                 b)))
            del ref
            # from one descent step (one sample per ROI) up: where the patch
            # kernel overtakes the direct one (global atomics into a zeroed
            # output that fits L2)
            for samples in (1, 2, 5, 10, 25):
                P1 = P // 25 * samples
                x1, y1 = x[:P1 * C].contiguous(), y[:P1 * C].contiguous()
                w1 = w[:, :P1 * C].contiguous()
                tag = dict(part=3, K=K, patches=P1, slots=C, patch=[PH, PW])
                emit(**tag, route="atlas (direct kernel + un-tiling)",
                     ms=T(chip_smoke.atlas_route(torch, cs, x1, y1, w1, P1,
                                                 C, PH, PW),
                          calls=2, reps=5))
                emit(**tag, route="patches direct", ms=T(
                    lambda: cs.bilinear_patches_scatter(
                        x1, y1, w1, P1, C, PH, PW, route="direct")))
                emit(**tag, route="patch, as shipped", ms=T(
                    lambda: cs.bilinear_patches_scatter(
                        x1, y1, w1, P1, C, PH, PW, route="patch")))
                for th in (256, 512, 1024):
                    emit(**tag, route="patch", channels_per_block=1,
                         threads=th, bulk=1, ms=T(lambda: patches(
                             x1, y1, w1, P1, C, PH, PW, 1, th, 1)))
            del x, y, w, x1, y1, w1
            torch.cuda.empty_cache()

    # ---- 4. the per-tile voxel kernel ---------------------------------------
    if 4 in parts:
        B = chip_smoke.B
        th_, tw_ = chip_smoke.TILE
        for sensor in ("720p", "VGA"):
            lx, ly, bt, bp, bmask, ts = chip_smoke.bucketed_tiles(
                torch, rng, chip_smoke.TILED_SENSORS[sensor], chip_smoke.TILE)
            args = cs.voxel_tiles_inputs(lx, ly, bt, bp, B, chip_smoke.TILE,
                                         ts[0], ts[-1], mask=bmask)
            Tn, cap = lx.shape
            ref = cs.voxel_tiles_scatter_plain(*args, B, th_, tw_)

            def tiles(mode, threads, bulk):
                out = torch.empty((Tn, B, th_, tw_), dtype=f32, device=dev)
                build.check(vlib.tiles_variant(
                    *(a.data_ptr() for a in args), Tn, cap, B, th_, tw_,
                    out.data_ptr(), mode, threads, bulk, stream()), "tiles")
                return out

            tag = dict(part=4, sensor=sensor, tiles=Tn, slots=cap)
            emit(**tag, route="direct", ms=T(
                lambda: cs.voxel_tiles_scatter(*args, B, th_, tw_,
                                               route="direct")))
            emit(**tag, route="private, as shipped", ms=T(
                lambda: cs.voxel_tiles_scatter(*args, B, th_, tw_,
                                               route="private")))
            names = {0: "replicated", 1: "cluster, remote atomics",
                     2: "replicated, launched as clusters"}
            for mode in (0, 2, 1):
                for threads in (256, 512, 1024):
                    for bulk in (1, 0):
                        ok = agrees(f"tiles mode={mode} threads={threads} "
                                    f"bulk={bulk} {tag}",
                                    tiles(mode, threads, bulk), ref)
                        emit(**tag, route=names[mode], threads=threads,
                             bulk=bulk, ok=ok,
                             ms=T(lambda: tiles(mode, threads, bulk)))

    # ---- 5. what a call costs the host ------------------------------------
    if 5 in parts:
        # The solvers wait on the host, so a route's enqueue cost counts too:
        # seconds of host time per eager call, no synchronisation inside.
        x0, y0, w0 = coords["scene_warped"]
        for m in (2048, n):
            x, y, w = (x0[:m].contiguous(), y0[:m].contiguous(),
                       w0[:, :m].contiguous())
            for route in ("direct", "private"):
                reps = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(200):
                        cs.bilinear_scatter(x, y, w, H, W, route=route)
                    reps.append((time.perf_counter() - t0) / 200)
                    torch.cuda.synchronize()
                emit(part=5, events=m, image=[H, W], route=route,
                     host_us_per_call=float(np.median(reps)) * 1e6)

    # ---- 6. what holds voxel_scatter and flat_scatter back ----------------
    Hs, Ws = chip_smoke.SENSOR
    Bn, N = chip_smoke.B, chip_smoke.N_VOXEL
    plane = Hs * Ws

    def ptrs(*tensors):
        return tuple(a.data_ptr() for a in tensors)

    def flat_variant(name, idx, w, nb):
        """'rows': one thread per (row, id) element; 'ahead': kAhead ids
        loaded before their reductions. Global atomics into zeros."""
        D, m = w.shape
        out = torch.zeros((D, nb), dtype=f32, device=dev)
        if name == "rows":
            rc = vlib.flat_rows(*ptrs(idx, w), m, D, nb, out.data_ptr(), 0,
                                stream())
        else:
            rc = vlib.flat_ahead(*ptrs(idx, w), m, D, nb, out.data_ptr(),
                                 stream())
        build.check(rc, f"flat {name}")
        return out

    def voxel_single(args, bins, h, wd):
        """One accumulator: float2 for even first bins, two scalars for odd
        ones, then a transpose."""
        Bp = (bins + 2) & ~1
        acc = torch.zeros((h * wd, Bp), dtype=f32, device=dev)
        out = torch.empty((bins, h, wd), dtype=f32, device=dev)
        build.check(vlib.voxel_single(*ptrs(*args), args[0].shape[0], bins,
                                      h, wd, Bp, *ptrs(acc, out), stream()),
                    "voxel_single")
        return out

    def voxel_stream(sensor, seed):
        xs, ys, ts, ps = (torch.as_tensor(a, device=dev) for a in
                          chip_smoke.voxel_events(np.random.default_rng(seed),
                                                  sensor))
        return xs, ys, ts.float(), ps.float()

    if 6 in parts:
        for path in (build._lib_path("scatter_kernels"), vlib._name):
            emit(part=6, what="reductions and atomics in the SASS",
                 lib=os.path.basename(str(path)),
                 mnemonics=sass_reductions(build, path))
        sums = torch.empty(132 * 16 * 256, dtype=f32, device=dev)
        # the voxel kernel at the smoke's shape
        ev = voxel_stream(chip_smoke.SENSOR, chip_smoke.SEED)
        vargs = cs.voxel_inputs(*ev, Bn, chip_smoke.SENSOR)
        grid = torch.empty((Bn, Hs, Ws), dtype=f32, device=dev)
        tag = dict(part=6, kernel="voxel", events=N, grid=[Bn, Hs, Ws])
        emit(**tag, what="torch.zeros of the grid alone",
             ms=T(lambda: torch.zeros((Bn, Hs, Ws), dtype=f32, device=dev)))
        emit(**tag, what="torch.zeros of the two accumulators alone",
             ms=T(lambda: torch.zeros((2, plane, 6), dtype=f32, device=dev)))
        emit(**tag, what="zeros + direct kernel",
             ms=T(lambda: cs.voxel_scatter(*vargs, Bn, Hs, Ws,
                                           route="direct")))
        emit(**tag, what="direct kernel alone (no memset)",
             ms=T(lambda: build.check(lib.voxel_scatter_batched(
                 *ptrs(*vargs), 1, N, Bn, Hs, Ws, 0, grid.data_ptr(),
                 stream()), "voxel")))
        emit(**tag, what="probe: atomics replaced by a register sum",
             ms=T(lambda: build.check(vlib.voxel_probe(
                 *ptrs(*vargs), N, Bn, Hs, Ws, sums.data_ptr(), stream()),
                 "voxel_probe")))
        # the flat kernel on the D=2 derivative stack of 200k events
        x, y, w = coords["uniform"]
        fi, fw = chip_smoke.derivative_stack(torch, x, y, w[0], (H, W))
        D, m = fw.shape
        nb = H * W
        out = torch.empty((D, nb), dtype=f32, device=dev)
        tag = dict(part=6, kernel="flat", D=D, ids=m, buckets=nb)
        emit(**tag, what="torch.zeros of the output alone",
             ms=T(lambda: torch.zeros((D, nb), dtype=f32, device=dev)))
        emit(**tag, what="zeros + kernel, one thread per (row, id)",
             ms=T(lambda: flat_variant("rows", fi, fw, nb)))
        emit(**tag, what="kernel alone, one thread per (row, id)",
             ms=T(lambda: build.check(vlib.flat_rows(
                 *ptrs(fi, fw), m, D, nb, out.data_ptr(), 0, stream()),
                 "flat_rows")))
        emit(**tag, what="probe: the same, atomics replaced by a register sum",
             ms=T(lambda: build.check(vlib.flat_rows(
                 *ptrs(fi, fw), m, D, nb, sums.data_ptr(), 1, stream()),
                 "flat_rows")))
        emit(**tag, what="zeros + direct kernel, one thread per id",
             ms=T(lambda: cs.flat_scatter(fi, fw, nb, route="direct")))
        # the L2's rate of reductions
        modes = ((0, "one scalar", 1, 1), (1, "two scalars, half a buffer "
                                           "apart", 2, 2),
                 (2, "two adjacent scalars", 2, 2), (3, "one float2", 1, 2),
                 (4, "one float4", 1, 4))
        for F in (Bn * plane, 1 << 19):
            buf = torch.zeros(F, dtype=f32, device=dev)
            for mode, name, requests, floats in modes:
                run = lambda: build.check(vlib.red_probe(
                    buf.data_ptr(), F, N, mode, stream()), "red_probe")
                buf.zero_()
                run()
                ok = float(buf.double().sum()) == float(N * floats)
                if not ok:
                    failed.append(f"red_probe mode {mode}: wrong sum")
                ms = T(run)
                emit(part=6, what="L2 reductions", threads=N, each_sends=name,
                     buffer_bytes=F * 4, ok=ok, ms=ms,
                     requests_per_s=N * requests / ms * 1e3,
                     floats_per_s=N * floats / ms * 1e3)
        # atomicAdd on shared memory: int (native) against float
        blocks, cells = 132 * 8, 8192
        for as_float in (0, 1):
            res = torch.empty(blocks * cells, device=dev,
                              dtype=f32 if as_float else torch.int32)
            times = {}
            for per_thread in (0, 64):
                times[per_thread] = T(lambda: build.check(
                    vlib.shared_atomic_probe(res.data_ptr(), blocks,
                                             per_thread, cells, as_float,
                                             stream()), "shared probe"))
            adds = blocks * 256 * 64
            ok = float(res.double().sum()) == 1.5 * adds   # 1, 2, 1, 2..
            if not ok:
                failed.append(f"shared probe as_float={as_float}: wrong sum")
            emit(part=6, what="atomicAdd on shared memory",
                 type="float" if as_float else "int", adds=adds, ok=ok,
                 ms=times[64], ms_without_adds=times[0],
                 adds_per_s=adds / (times[64] - times[0]) * 1e3)

    # ---- 7. voxel routes over event counts and sensors --------------------
    if 7 in parts:
        for sensor, bins in ((chip_smoke.SENSOR, Bn), (chip_smoke.SENSOR, 9),
                             ((480, 640), Bn), ((720, 1280), Bn)):
            h, wd = sensor
            ev = voxel_stream(sensor, chip_smoke.SEED + 1)
            for m in (4096, 16384, 65536, 131072, 262144, 524288, 1 << 20, N):
                args = cs.voxel_inputs(*(a[:m] for a in ev), bins, sensor)
                ref = cs.voxel_scatter_plain(*args, bins, h, wd)
                tag = dict(part=7, sensor=[h, wd], bins=bins, events=m,
                           dispatch=cs.voxel_batched_route(1, m, bins, h,
                                                           wd))
                for route in ("direct", "vector"):
                    run = lambda: cs.voxel_scatter(*args, bins, h, wd,
                                                   route=route)
                    ok = agrees(f"voxel {route} {tag}", run(), ref)
                    emit(**tag, route=f"{route}, as shipped", ok=ok,
                         ms=T(run))
                ok = agrees(f"voxel one accumulator {tag}",
                            voxel_single(args, bins, h, wd), ref)
                emit(**tag, route="one accumulator (float2 or two scalars)",
                     ok=ok, ms=T(lambda: voxel_single(args, bins, h, wd)))

    # ---- 8. flat routes over id counts and row counts ---------------------
    if 8 in parts:
        x, y, w = coords["uniform"]
        fi, fw = chip_smoke.derivative_stack(torch, x, y, w[0], (H, W))
        nb = H * W
        frng = np.random.default_rng(chip_smoke.SEED + 2)
        cases = [(2, "derivative stack", fi[:m].contiguous(),
                  fw[:, :m].contiguous(), nb)
                 for m in (4096, 16384, 65536, 131072, 262144, fi.shape[0])]
        ex, ey, _, ep = voxel_stream(chip_smoke.SENSOR, chip_smoke.SEED + 3)
        eid = ey.int() * Ws + ex.int()
        cases += [(1, "event image", eid[:m].contiguous(),
                   ep[None, :m].contiguous(), plane)
                  for m in (65536, 262144, N)]
        rid = torch.as_tensor(frng.integers(-3, nb + 3, n), dtype=torch.int32,
                              device=dev)
        cases += [(D, "random ids", rid, t(frng.normal(size=(D, n))), nb)
                  for D in (3, 4, 5, 8)]
        # many buckets: the scratch and its second pass grow with them
        vga = 480 * 640
        wide = torch.as_tensor(frng.integers(0, vga, N), dtype=torch.int32,
                               device=dev)
        cases += [(2, "random ids", wide[:m].contiguous(),
                   t(frng.normal(size=(2, m))), vga)
                  for m in (262144, 524288, N)]
        for D, what, idx, wts, buckets in cases:
            ref = cs.flat_scatter_plain(idx, wts, buckets)
            tag = dict(part=8, D=D, ids=idx.shape[0], buckets=buckets,
                       data=what,
                       dispatch=cs.flat_route(D, idx.shape[0], buckets))
            for route in ("direct", "vector")[:2 if D > 1 else 1]:
                run = lambda: cs.flat_scatter(idx, wts, buckets, route=route)
                ok = agrees(f"flat {route} {tag}", run(), ref)
                emit(**tag, route=f"{route}, as shipped", ok=ok, ms=T(run))
            for name in ("rows", "ahead"):
                ok = agrees(f"flat {name} {tag}",
                            flat_variant(name, idx, wts, buckets), ref)
                emit(**tag, route=name, ok=ok,
                     ms=T(lambda: flat_variant(name, idx, wts, buckets)))


    # ---- 9. the private kernel's blocks, the cluster variant ---------
    if 9 in parts:
        I = ctypes.c_int

        def occupancy(G, threads, smem, grouped):
            active = I(0)
            build.check(vlib.cluster_wide_occupancy(
                G, threads, smem, grouped, ctypes.addressof(active)),
                "occupancy")
            return active.value

        # the cluster kernel with a 181x241 image, the grouped kernel with a
        # (64, 128) patch as the few-patch variant runs it
        for threads, (h, wd), grouped in ((1024, (H, W), 0),
                                          (256, (64, 128), 1)):
            emit(part=9, what="clusters resident at once", threads=threads,
                 plane=[h, wd], grouped=grouped,
                 active={G: occupancy(G, threads, h * wd * 4, grouped)
                         for G in range(1, 17)})
        sx_, sy_, st_, sp_ = chip_smoke.planted_scene(
            np.random.default_rng(chip_smoke.SEED))
        tt, ex, ey, ep = t(st_ - st_[-1]), t(sx_), t(sy_), t(sp_)

        def warped(v, m=n):
            v = t(v)
            x = (ex[:m] - tt[:m] * v[:, 0:1]).contiguous()
            y = (ey[:m] - tt[:m] * v[:, 1:2]).contiguous()
            ok = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
            return x, y, (ep[:m] * ok)[:, None, :].contiguous()

        level = chip_smoke.grid_samples(np.linspace(-150.0, 150.0, 5))
        land = chip_smoke.grid_samples(np.arange(-190.0, 200.0, 20.0))
        crng = np.random.default_rng(9)
        corner = crng.uniform(0, [W - 21, H - 21], (2700, 1, 2))
        rows = (t(corner[..., 0] + crng.uniform(0, 20, (2700, 2048))),
                t(corner[..., 1] + crng.uniform(0, 20, (2700, 2048))),
                t(crng.choice([-1.0, 1.0], (2700, 1, 2048))))
        ux, uy, uw = coords["uniform"]
        pile = torch.full((25, n), 100.5, dtype=f32, device=dev)
        vrng = np.random.default_rng(3)
        images = [
            ("S=1 uniform", ux[None], uy[None], uw),
            ("S=1 warped scene", *warped(np.array([[vx, vy]]))),
            ("grid level 25 x 200k", *warped(level)),
            # a loss chunk holds 2^24 // N samples of N events
            ("chunk 83 x 200k", *warped(vrng.uniform(-150, 150, (83, 2)))),
            ("chunk 129 x 130k", *warped(vrng.uniform(-150, 150, (129, 2)),
                                         130000)),
            ("chunk 167 x 100k", *warped(vrng.uniform(-150, 150, (167, 2)),
                                         100000)),
            ("landscape 400 x 15k", *warped(land, 15000)),
            ("stream level 25 x 20k", *warped(level, 20000)),
            ("ROI rows 2700 x 2048", *rows),
            ("25 x 200k on one pixel", pile, pile * 0.5,
             uw.abs()[None].expand(25, 1, n).contiguous()),
        ]
        # the samples one launch takes and one more (two launches through
        # the wrapper), 4 events a sample into 6x8, as the smoke's case
        for S in (cs.BATCH_MAX_SAMPLES, cs.BATCH_MAX_SAMPLES + 1):
            images.append((f"{S} x 4 into 6x8", *(
                t(vrng.uniform(-1, hi, (S, 4))) for hi in (9, 7)),
                t(vrng.normal(size=(1, 4))), (6, 8)))
        if only:
            images = [c for c in images if any(k in c[0] for k in only)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        def within(what, got, x, y, w, h, wd):
            """The smoke's per-pixel rule (splat_limits) against the plain
            version in float64; a miss is reported."""
            try:
                limit = chip_smoke.splat_limits(torch, x, y, w, h, wd)
                chip_smoke.check_splat(
                    what, got, cs.bilinear_scatter_batched_plain(
                        x.double(), y.double(), w.double(), h, wd), limit)
                return True
            except AssertionError as e:
                failed.append(str(e))
                return False

        for label, x, y, w, *dims in images:
            S, m = x.shape
            K = w.shape[-2]
            ws = K * m if w.dim() == 3 else 0
            h, wd = dims[0] if dims else (H, W)
            tag = dict(part=9, case=label, samples=S, events=m)
            def cluster(G, c, grouped, slots=m, out=None):
                alloc = torch.empty if c == 1 else torch.zeros
                out = alloc((S, K, h, wd), dtype=f32, device=dev) \
                    if out is None else out
                build.check(vlib.cluster_wide(
                    x.data_ptr(), y.data_ptr(), w.data_ptr(), S, slots, ws, K,
                    h, wd, out.data_ptr(), G, c, grouped, stream()),
                    f"cluster G={G} c={c}")
                return out

            def private(blocks, slots=m, out=None):
                alloc = torch.empty if blocks == 1 else torch.zeros
                out = alloc((S, K, h, wd), dtype=f32, device=dev) \
                    if out is None else out
                build.check(lib.bilinear_scatter_batched_private(
                    x.data_ptr(), y.data_ptr(), w.data_ptr(), S, slots, ws, K,
                    h, wd, out.data_ptr(), blocks, stream()), "private")
                return out

            shipped = lambda: cs.bilinear_scatter_batched(
                x, y, w, h, wd, route="private")
            if S > cs.BATCH_MAX_SAMPLES:
                # one launch takes up to BATCH_MAX_SAMPLES: the wrapper's
                # two launches, against two of the cluster kernel's (G = 1)
                c0 = cs.BATCH_MAX_SAMPLES

                def two():
                    out = torch.empty((S, K, h, wd), dtype=f32, device=dev)
                    for s0 in (0, c0):
                        s1 = min(S, s0 + c0)
                        build.check(vlib.cluster_wide(
                            x[s0:s1].data_ptr(), y[s0:s1].data_ptr(),
                            w.data_ptr(), s1 - s0, m, 0, K, h, wd,
                            out[s0:s1].data_ptr(), 1, 1, 0, stream()),
                            "two launches")
                    return out

                emit(**tag, route="private, as shipped",
                     blocks=cs.private_blocks(c0, m), ms=T(shipped))
                emit(**tag, route="cluster", G=1, clusters=1, grouped=0,
                     ms=T(two))
                continue

            if label in ("S=1 uniform", "grid level 25 x 200k"):
                # what a launch costs with no slot to splat
                out0 = torch.zeros((S, K, h, wd), dtype=f32, device=dev)
                for blocks in (1, 5, 132):
                    if S * blocks <= 2 * sms:
                        emit(**tag, route="private kernel, no slots",
                             blocks=blocks, ms=T(lambda: private(
                                 blocks, 0, out0)))
                for G, c in ((1, 1), (1, 5), (4, 1), (8, 1), (1, 132)):
                    if S * G * c <= 2 * sms:
                        emit(**tag, route="cluster, no slots", G=G,
                             clusters=c, ms=T(lambda: cluster(G, c, 0, 0,
                                                              out0)))
            blocks = cs.private_blocks(S, m)
            ok = within(f"private, as shipped {tag}", shipped(), x, y, w, h,
                        wd)
            emit(**tag, route="private, as shipped", blocks=blocks, ok=ok,
                 ms=T(shipped))
            # the blocks that fill one wave of the SMs (the single image:
            # 2 .. 132 blocks), and, where one block a sample leaves SMs
            # idle or a last wave part-full, more blocks a sample in waves
            wave = max(1, min(-(-m // 1024), sms // S))
            if S == 1:
                wave = max(2, min(sms, -(-m // 1024)))
            tries = {wave}
            if sms < 2 * S < 4 * sms and m > 20000:
                tries |= {1, 2, 3, 4, 6}
            for b in sorted(tries - {blocks}):
                ok = within(f"private {b} {tag}", private(b), x, y, w, h, wd)
                emit(**tag, route="private kernel", blocks=b, ok=ok,
                     ms=T(lambda: private(b)))
            for G in (1, 2, 3, 4, 5, 8, 16):
                counts = {1}
                if S < 66:
                    counts |= {c for c in (2, 4, 8, 16, 33, 66, 132)
                               if S * G * c <= 2 * sms}
                if S >= 400 and G > 2:
                    continue
                for c in sorted(counts):
                    if G == 1 and c == 1 and S < 8 and m > 20000:
                        continue
                    for grouped in (2, 1, 0):
                        ok = within(f"cluster G={G} c={c} grouped={grouped} "
                                    f"{tag}", cluster(G, c, grouped), x, y, w,
                                    h, wd)
                        emit(**tag, route="cluster", G=G, clusters=c,
                             grouped=grouped, ok=ok,
                             ms=T(lambda: cluster(G, c, grouped)))
        torch.cuda.empty_cache()
        # patches: a descent step (the first 108 patches of one batched
        # loss evaluation), stream_flow's 1024 slots a patch, K = 4, and
        # every slot of every patch on one pixel
        for objective in ("variance", "zhu")[:0 if only else 2]:
            x, y, w, P, C, PH, PW = chip_smoke.patch_loss_inputs(
                torch, objective)
            R = P // 25
            K = w.shape[0]
            x, y, w = (x[:R * C].contiguous(), y[:R * C].contiguous(),
                       w[:, :R * C].contiguous())
            sets = [("descent step", x, y, w, C)]
            if K == 1:
                hc = C // 2
                sets += [("stream_flow 1024 slots",
                          x.view(R, C)[:, :hc].reshape(-1).contiguous(),
                          y.view(R, C)[:, :hc].reshape(-1).contiguous(),
                          w.view(K, R, C)[..., :hc].reshape(K, -1)
                          .contiguous(), hc),
                         ("all slots on one pixel", x * 0 + 60.5,
                          y * 0 + 30.5, w.abs(), C)]
            for label, px, py, pw, pc in sets:
                tag = dict(part=9, case=label, K=K, patches=R, slots=pc,
                           patch=[PH, PW])
                for route in ("direct", "patch"):
                    emit(**tag, route=f"{route}, as shipped", ms=T(
                        lambda: cs.bilinear_patches_scatter(
                            px, py, pw, R, pc, PH, PW, route=route)))

                def pcluster(G, grouped):
                    out = torch.empty((K, R, PH, PW), dtype=f32, device=dev)
                    build.check(vlib.patches_cluster(
                        px.data_ptr(), py.data_ptr(), pw.data_ptr(), R, pc, K,
                        PH, PW, out.data_ptr(), G, grouped, stream()),
                        "pcluster")
                    return out

                # each patch a sample of pc slots for the per-pixel rule
                sx_p, sy_p = px.view(R, pc), py.view(R, pc)
                sw_p = pw.view(K, R, pc).permute(1, 0, 2).contiguous()
                if label == "descent step":
                    # what a launch costs with no slot to splat: zeroing,
                    # the syncs, the combine and the stores
                    for G in (1, 2, 4, 8):
                        out0 = torch.empty((K, R, PH, PW), dtype=f32,
                                           device=dev)
                        emit(**tag, route="cluster, no slots", G=G, ms=T(
                            lambda: build.check(vlib.patches_cluster(
                                px.data_ptr(), py.data_ptr(), pw.data_ptr(),
                                R, 0, K, PH, PW, out0.data_ptr(), G, 1,
                                stream()), "pcluster")))
                for G in range(1, 9):
                    for grouped in (1, 0):
                        ok = within(f"patch cluster G={G} grouped={grouped} "
                                    f"{tag}", pcluster(G, grouped).permute(
                                        1, 0, 2, 3), sx_p, sy_p, sw_p, PH, PW)
                        emit(**tag, route="cluster", G=G, grouped=grouped,
                             ok=ok, ms=T(lambda: pcluster(G, grouped)))

    # ---- 10. the few-patch route over a whole solve ----------------------
    if 10 in parts:
        # every patch splat of fewer than 768 patches that the ROI solvers
        # make on the rotating scene (the descent's and the BFGS's), kept
        # and replayed on the direct and the cluster route: what the main
        # path's own coordinates cost on each
        from event_utils_tpu_torch.contrast_max import events_cmax as ec
        kept = []
        splat = ec.bilinear_patches_scatter

        def keep(x, y, w, P, C, PH, PW, route=None):
            if cs.bilinear_patches_route(P, PH, PW) != "patch":
                kept.append((x.detach().clone(), y.detach().clone(),
                             w.detach().clone(), P, C, PH, PW))
            return splat(x, y, w, P, C, PH, PW, route=route)

        rx, ry, rt, rp = chip_smoke.rotating_scene()
        ec.bilinear_patches_scatter = keep
        try:
            # the smoke's two solves, and a stream_flow-sized window: its
            # 20,000 events at 1024 slots a patch
            for solver, m, cap in (("gd", len(rx), chip_smoke.ROT_CAPACITY),
                                   ("bfgs", len(rx), chip_smoke.ROT_CAPACITY),
                                   ("gd", 20000, 1024)):
                kept.clear()
                ec.grid_cmax_batched(
                    rx[:m], ry[:m], rt[:m], rp[:m], solver=solver, device=dev,
                    roi_size=chip_smoke.ROT_ROI,
                    img_size=chip_smoke.ROT_SENSOR,
                    maxiter=chip_smoke.ROT_MAXITER, capacity=cap)
                picks = kept[::max(1, len(kept) // 40)]
                totals = {"direct": 0.0, "cluster": 0.0}

                def grouped_cluster(x, y, w, P, C, PH, PW, G=2):
                    out = torch.empty((w.shape[0], P, PH, PW), dtype=f32,
                                      device=dev)
                    build.check(vlib.patches_cluster(
                        x.data_ptr(), y.data_ptr(), w.data_ptr(), P, C,
                        w.shape[0], PH, PW, out.data_ptr(), G, 1, stream()),
                        "patches_cluster")
                    return out

                for x, y, w, P, C, PH, PW in picks:
                    totals["direct"] += T(lambda: cs.bilinear_patches_scatter(
                        x, y, w, P, C, PH, PW, route="direct"))
                    totals["cluster"] += T(lambda: grouped_cluster(
                        x, y, w, P, C, PH, PW))
                emit(part=10, solver=solver, calls=len(kept),
                     timed=len(picks), shape=list(kept[0][3:]),
                     **{f"{r}_ms_mean": v / len(picks)
                        for r, v in totals.items()})
        finally:
            ec.bilinear_patches_scatter = splat

    # ---- 11. the few-event band variants and the vector routes ---------
    # --cases picks sections of this part: floor, few, sweep, many
    sect = lambda name: not only or name in only
    if 11 in parts and sect("floor"):
        emit(part=11, what="empty kernel (torch.cuda._sleep(0)), the floor "
             "of one graph node", ms=T(lambda: torch.cuda._sleep(0)))
        one = torch.zeros(1, dtype=f32, device=dev)
        emit(part=11, what="one-float fill kernel", ms=T(lambda: one.fill_(1)))

    def band(x, y, w, S, m, K, h, wd, rows, threads, mode=0):
        out = torch.empty((S, K, h, wd), dtype=f32, device=dev)
        build.check(vlib.band_variant(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), S, m,
            K * m if w.dim() == 3 else 0, K, h, wd, rows, threads, mode,
            out.data_ptr(), stream()), f"band rows={rows}")
        return out

    def plane(x, y, w, S, m, K, h, wd):
        out = torch.empty((S, K, h, wd), dtype=f32, device=dev)
        build.check(vlib.plane_variant(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), S, m,
            K * m if w.dim() == 3 else 0, K, h, wd, out.data_ptr(),
            stream()), "plane")
        return out

    def held(what, got, x, y, w, h, wd):
        """The smoke's per-pixel rule against the plain version in float64
        (S samples; w (K, m) shared or (S, K, m))."""
        try:
            limit = chip_smoke.splat_limits(torch, x, y, w, h, wd)
            chip_smoke.check_splat(
                what, got.view(x.shape[0], w.shape[-2], h, wd),
                cs.bilinear_scatter_batched_plain(
                    x.double(), y.double(), w.double(), h, wd), limit)
            return True
        except AssertionError as e:
            failed.append(str(e))
            return False

    if 11 in parts and sect("few"):
        # what one splat of few events costs beside its work: the memset
        # alone, the direct kernel without it, the band variant with no
        # events; and the host's time per eager call (200 calls, then one
        # synchronisation), what a host-bound solver pays, on the direct
        # route and the band variant (rows in the output, 6 rows a band)
        prng = np.random.default_rng(12)
        for m in (0, 512, 2048):
            x = t(prng.uniform(-2, W + 1, m))
            y = t(prng.uniform(-2, H + 1, m))
            w = t(prng.uniform(-1, 1, (1, m)))
            tag = dict(part=11, image=[H, W], K=1, samples=1, events=m)
            if m == 0:
                emit(**tag, what="torch.zeros of the image alone",
                     ms=T(lambda: torch.zeros((1, H, W), dtype=f32,
                                              device=dev)))
                emit(**tag, what="band variant, no events", ms=T(
                    lambda: band(x[None], y[None], w, 1, 0, 1, H, W, 6,
                                 512)))
                continue
            scratch = torch.empty((1, H, W), dtype=f32, device=dev)
            emit(**tag, what="direct kernel alone (no memset)",
                 ms=T(lambda: direct_raw(x, y, w, H, W, scratch)))
            calls = {"direct": lambda: cs.bilinear_scatter(x, y, w, H, W,
                                                           route="direct"),
                     "band": lambda: band(x[None], y[None], w, 1, m, 1, H, W,
                                          6, 512)}
            walls = {r: [] for r in calls}
            for r in ("direct", "band", "band", "direct") * 3:
                for _ in range(20):
                    calls[r]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    calls[r]()
                torch.cuda.synchronize()
                walls[r].append((time.perf_counter() - t0) / 200 * 1e3)
            for r, v in walls.items():
                emit(**tag, route=r, what="eager wall a call (host clock, "
                     "200 calls, 6 rounds in turns)", ms=float(np.median(v)),
                     rounds=v)

    brng = np.random.default_rng(11)
    if 11 in parts and sect("sweep"):
        # (image, K, S, events) where the band variant's block size and
        # shared-memory forms are swept
        threads_at = {((181, 241), 1, 1, 2048), ((181, 241), 1, 1, 20000),
                      ((181, 241), 1, 25, 2048), ((181, 241), 4, 1, 2048),
                      ((480, 640), 1, 1, 8192)}
        for h, wd in ((21, 21), (181, 241), (240, 256), (480, 640)):
            for K in (1, 4):
                most = cs.SHARED_MAX_BYTES // (4 * K * wd)
                allowed = cs._bilinear_allowed(K, h, wd)
                for S in (1, 25):
                    for m in (512, 2048, 4096, 8192, 20000, 32768, 65536,
                              131072):
                        x = t(brng.uniform(-2, wd + 1, (S, m)))
                        y = t(brng.uniform(-2, h + 1, (S, m)))
                        w = t(brng.uniform(-1, 1, (K, m) if S == 1
                                           else (S, K, m)))
                        tag = dict(part=11, image=[h, wd], K=K, samples=S,
                                   events=m)
                        if S == 1:
                            call = lambda r: cs.bilinear_scatter(
                                x[0], y[0], w, h, wd, route=r)
                        else:
                            call = lambda r: cs.bilinear_scatter_batched(
                                x, y, w, h, wd, route=r)
                        for r in ("direct", "private", "vector"):
                            if r not in allowed:
                                continue
                            ok = (held(f"{r} {tag}", call(r), x, y, w, h, wd)
                                  if r == "vector" else True)
                            emit(**tag, route=f"{r}, as shipped", ok=ok,
                                 ms=T(lambda: call(r)))
                        rows_set = sorted({-(-h // g) for g in
                                           (1, 2, 4, 8, 16, 32, 64, 128, h)})
                        swept = ((h, wd), K, S, m) in threads_at
                        for rows in rows_set:
                            # the rows in the output (mode 0), and where
                            # swept in shared memory (1: per-thread stores,
                            # 2: bulk); each form held once a shape
                            modes = (0, 1, 2) if swept and rows <= most \
                                else (0,)
                            for th in (256, 512, 1024) if swept else (512,):
                                for mode in modes:
                                    run_ = lambda: band(x, y, w, S, m, K, h,
                                                        wd, rows, th, mode)
                                    ok = (held(f"band {tag} rows={rows} "
                                               f"mode={mode}", run_(), x, y,
                                               w, h, wd)
                                          if rows == rows_set[len(rows_set)
                                                              // 2]
                                          and th == 512 else None)
                                    emit(**tag, route="band variant",
                                         rows=rows, bands=-(-h // rows),
                                         threads=th, mode=mode, ok=ok,
                                         ms=T(run_))

    def vector_chunks(x, y, w, K, h, wd, c):
        """The batched vector kernels over S samples in launches of c: one
        zeroed scratch of c samples, zeroed again before each later launch
        (as a chunked wrapper would run them)."""
        S, m = x.shape
        Kp = cs.vector_channels(K)
        scratch = torch.zeros((min(S, c), h * wd, Kp), dtype=f32, device=dev)
        out = torch.empty((S, K, h, wd), dtype=f32, device=dev)
        for s0 in range(0, S, c):
            s1 = min(S, s0 + c)
            if s0:
                scratch.zero_()
            build.check(lib.bilinear_scatter_batched_vector(
                x[s0:s1].data_ptr(), y[s0:s1].data_ptr(),
                w[s0:s1].data_ptr(), s1 - s0, m, K * m, K, h, wd, Kp,
                scratch.data_ptr(), out[s0:s1].data_ptr(), stream()),
                f"vector chunk={c}")
        return out

    if 11 in parts and sect("many"):
        # K = 4 at the main path's many events into 181x241: the timestamp
        # image (S = 1), zhu's grid level (25 samples, per-sample weights)
        # and a loss chunk of 2^24 // 200k = 83 samples, each on the direct
        # and vector routes as shipped, the vector kernels in launches of c
        # samples (c = S: one launch), and one private plane per (sample,
        # channel)
        for S in (1, 25, 83):
            m = n
            x = t(brng.uniform(-2, W + 1, (S, m)))
            y = t(brng.uniform(-2, H + 1, (S, m)))
            w = t(brng.uniform(0, 1, (4, m) if S == 1 else (S, 4, m)))
            tag = dict(part=11, image=[H, W], K=4, samples=S, events=m)
            call = ((lambda r: cs.bilinear_scatter(x[0], y[0], w, H, W,
                                                   route=r)) if S == 1 else
                    (lambda r: cs.bilinear_scatter_batched(x, y, w, H, W,
                                                           route=r)))
            for r in ("direct", "vector"):
                ok = held(f"{r} {tag}", call(r), x, y, w, H, W)
                emit(**tag, route=f"{r}, as shipped", ok=ok,
                     ms=T(lambda: call(r)))
            ok = held(f"plane {tag}", plane(x, y, w, S, m, 4, H, W), x, y,
                      w, H, W)
            emit(**tag, route="plane (one private plane a channel)", ok=ok,
                 ms=T(lambda: plane(x, y, w, S, m, 4, H, W)))
            if S == 1:
                continue
            for c in ((1, 3, 5, 9, 13, 25) if S == 25 else
                      (10, 21, 30, 42, 83)):
                ok = held(f"vector chunk={c} {tag}",
                          vector_chunks(x, y, w, 4, H, W, c), x, y, w, H, W)
                emit(**tag, route="vector", chunk=c, launches=-(-S // c),
                     ok=ok, ms=T(lambda: vector_chunks(x, y, w, 4, H, W, c)))

    # ---- 12. the batched voxel routes: private layouts, chunked direct ---
    if 12 in parts:
        def voxel_private(args, bins, h, wd, split, layout, ahead=4, mode=0,
                          m=None):
            """The private kernel's variant with run-time knobs
            (``voxel_private_variant``; ahead 4 and mode 0 are the package's
            kernel) at an explicit ``(planes, rows, threads)``: bands of
            ``rows`` rows a block; ``m = 0`` launches it with no events
            (zero and store alone)."""
            S = args[0].shape[0]
            out = torch.empty((S, (2 if split else 1) * bins, h, wd),
                              dtype=f32, device=dev)
            build.check(vlib.voxel_private_variant(
                *ptrs(*args), S, args[0].shape[1] if m is None else m, bins,
                h, wd, int(split), *layout, ahead, mode, out.data_ptr(),
                stream()), f"private {layout} {ahead} {mode}")
            return out

        def direct_chunks(args, bins, h, wd, split, c):
            """The direct kernel on c rows a launch, each chunk of grids
            zeroed just before its launch, so that it stays in the L2."""
            S, m = args[0].shape
            out = torch.empty((S, (2 if split else 1) * bins, h, wd),
                              dtype=f32, device=dev)
            for s0 in range(0, S, c):
                s1 = min(S, s0 + c)
                out[s0:s1].zero_()
                build.check(lib.voxel_scatter_batched(
                    *(a[s0:s1].data_ptr() for a in args), s1 - s0, m, bins,
                    h, wd, int(split), out[s0:s1].data_ptr(), stream()),
                    f"direct chunk={c}")
            return out

        def layouts(h, wd, split, full):
            out = []
            for planes in (1, 2) if split else (1,):
                for rows in sorted({h, -(-h // 2), -(-h // 3), -(-h // 4)},
                                   reverse=True):
                    if planes * rows * wd * 4 > cs.SHARED_MAX_BYTES or (
                            not full and rows == -(-h // 3)):
                        continue
                    for threads in (256, 512, 1024) if full else (512, 1024):
                        out.append((planes, rows, threads))
            return out

        vev = voxel_stream(chip_smoke.SENSOR, chip_smoke.SEED + 12)
        cases = []
        for m in (chip_smoke.FIXED_N, chip_smoke.FIXED_N_VECTOR):
            S = N // m
            win = [a[:S * m].reshape(S, m) for a in vev]
            cases.append((f"DAVIS240, {S} windows of {m}", True,
                          cs.voxel_inputs_batched(*win, Bn, (Hs, Ws)),
                          (Hs, Ws), False))
        prng = np.random.default_rng(chip_smoke.SEED + 12)
        for label, S, m, sensor, full in (
                ("fit", 8, 32768, (184, 240), True),
                ("flow batch", 8, 65536, (128, 128), True),
                ("E2VID windows", 96, 12288, (128, 128), True),
                ("sweep", 8, 8192, (184, 240), False),
                ("sweep", 8, 131072, (184, 240), False),
                ("sweep", 8, 4096, (128, 128), False),
                ("sweep", 8, 16384, (128, 128), False),
                ("sweep", 32, 12288, (128, 128), False),
                ("sweep", 32, 65536, (128, 128), False),
                ("sweep", 96, 4096, (128, 128), False),
                ("sweep", 96, 65536, (128, 128), False)):
            ev, mask = chip_smoke.padded_rows(torch, prng, S, m, sensor)
            rows_ = [a.contiguous() for a in ev.unbind(-1)]
            cases.append((label, full, cs.voxel_inputs_batched(
                *rows_, Bn, sensor, mask=mask, split=True), sensor, True))
        for S, m in ((8, 4096), (8, 20000), (8, 65536), (32, 4096),
                     (32, 20000), (32, 65536), (32, 262144), (104, 4096),
                     (104, 65536)):
            # each row a time-sorted draw of the stream's events
            idx = torch.sort(torch.as_tensor(prng.integers(0, N, (S, m)),
                                             device=dev), dim=1).values
            win = [a[idx] for a in vev]
            cases.append(("sweep", False, cs.voxel_inputs_batched(
                *win, Bn, (Hs, Ws)), (Hs, Ws), False))
        for label, full, args, (h, wd), split in cases:
            routes = sect("paths" if full else "sweep")
            knobs = full and sect("knobs")
            if not (routes or knobs):
                continue
            S, m = args[0].shape
            G = 2 if split else 1
            ref = cs.voxel_scatter_batched_plain(*args, Bn, h, wd, split)
            tag = dict(part=12, shape=label, rows=S, events=m, bins=Bn,
                       sensor=[h, wd], split=split,
                       dispatch=cs.voxel_batched_route(S, m, Bn, h, wd,
                                                       split))
            picks = [(1, h, 1024), (1, -(-h // 2), 1024),
                     (1, -(-h // 2), 512)]
            if split:
                picks.append((2, h, 1024) if 2 * h * wd * 4 <=
                             cs.SHARED_MAX_BYTES else (2, -(-h // 3), 1024))
            for layout in picks if knobs else ():
                for ahead in (4, 8):
                    for mode in (0, 1, 2, 3, 4, 6):
                        if mode & 2 and m % 4:
                            continue
                        run = lambda: voxel_private(args, Bn, h, wd, split,
                                                    layout, ahead, mode)
                        ok = bool(mode & 4) or agrees(
                            f"private knobs {layout} {ahead} {mode} {tag}",
                            run(), ref)
                        emit(**tag, route="private knobs",
                             layout=list(layout), ahead=ahead, mode=mode,
                             ok=ok, ms=T(run))
            if not routes:
                continue
            emit(**tag, what="torch.zeros of the grids alone",
                 ms=T(lambda: torch.zeros((S, G * Bn, h, wd), dtype=f32,
                                          device=dev)))
            for r in ("direct", "vector", "private"):
                run = lambda: cs.voxel_scatter_batched(*args, Bn, h, wd,
                                                       split=split, route=r)
                ok = agrees(f"batched voxel {r} {tag}", run(), ref)
                emit(**tag, route=f"{r}, as shipped", ok=ok, ms=T(run))
            for layout in layouts(h, wd, split, full):
                ok = agrees(f"batched voxel private {layout} {tag}",
                            voxel_private(args, Bn, h, wd, split, layout),
                            ref)
                emit(**tag, route="private variant", layout=list(layout),
                     ok=ok,
                     ms=T(lambda: voxel_private(args, Bn, h, wd, split,
                                                layout)),
                     ms_no_events=T(lambda: voxel_private(
                         args, Bn, h, wd, split, layout, m=0))
                     if full else None)
            if full and S > 16:
                for c in (8, 16, 24, 40, 52):
                    ok = agrees(f"batched voxel direct chunk={c} {tag}",
                                direct_chunks(args, Bn, h, wd, split, c), ref)
                    emit(**tag, route="direct in chunks", chunk=c, ok=ok,
                         ms=T(lambda: direct_chunks(args, Bn, h, wd, split,
                                                    c)))
        # around PRIVATE_MIN_GRID_BYTES: the routes as shipped, 24-80 rows
        for (h, wd), split, counts, ms_ in (
                ((Hs, Ws), False, (24, 28, 40, 48, 56, 64, 80),
                 (4096, 20000, 65536)),
                ((128, 128), True, (40, 48, 64, 80), (4096, 12288, 65536))):
            for S in counts if sect("rule") else ():
                for m in ms_:
                    if split:
                        ev, mask = chip_smoke.padded_rows(torch, prng, S, m,
                                                          (h, wd))
                        args = cs.voxel_inputs_batched(
                            *(a.contiguous() for a in ev.unbind(-1)), Bn,
                            (h, wd), mask=mask, split=True)
                    else:
                        idx = torch.sort(torch.as_tensor(
                            prng.integers(0, N, (S, m)), device=dev),
                            dim=1).values
                        args = cs.voxel_inputs_batched(
                            *(a[idx] for a in vev), Bn, (h, wd))
                    ref = cs.voxel_scatter_batched_plain(*args, Bn, h, wd,
                                                         split)
                    tag = dict(part=12, shape="rule", rows=S, events=m,
                               bins=Bn, sensor=[h, wd], split=split,
                               grid_mb=S * (2 if split else 1) * Bn * h * wd
                               * 4 / 2 ** 20,
                               dispatch=cs.voxel_batched_route(
                                   S, m, Bn, h, wd, split))
                    for r in ("direct", "vector", "private"):
                        run = lambda: cs.voxel_scatter_batched(
                            *args, Bn, h, wd, split=split, route=r)
                        ok = agrees(f"batched voxel {r} {tag}", run(), ref)
                        emit(**tag, route=f"{r}, as shipped", ok=ok,
                             ms=T(run))

    print(chip_smoke.card_line(), flush=True)
    if failed:
        print("DISAGREED:\n" + "\n".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
