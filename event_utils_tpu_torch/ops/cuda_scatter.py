"""Hand-written CUDA accumulation kernels, their plain versions and drivers.

Counterpart of the JAX package's ``ops/pallas_scatter.py``. The TPU kernels
there recast scatter-add as one-hot matmuls on the MXU, because a TPU has no
fast scatter. An H100 has atomics in its L2 and in each SM's shared memory,
so the kernels in ``csrc/scatter_kernels.cu`` compute the same functions
directly:

================================  =========================================
kernel wrapper (this module)      TPU kernel it replaces (pallas_scatter.py)
================================  =========================================
``voxel_scatter``                 ``_voxel_kernel`` via ``voxel_matmul``
``voxel_scatter_batched``         ``_voxel_kernel`` under ``jax.vmap``
                                  (``voxel_grids_fixed_n``, the trainers'
                                  padded rows)
``voxel_tiles_scatter``           ``_voxel_kernel`` on the (tile, chunk)
                                  grid via ``voxel_matmul_tiles``
``flat_scatter``                  ``_image_kernel`` via ``image_matmul`` and
                                  ``scatter_add_flat_pallas``
``bilinear_scatter``,             ``_bilinear_kernel`` via
``bilinear_patches_scatter``      ``bilinear_matmul``
``bilinear_scatter_batched``      ``_bilinear_kernel`` under ``jax.vmap``
                                  (the grid searches' samples)
================================  =========================================

Every wrapper has several kernels, called routes. A route is chosen from
the call's shape before the launch (``voxel_route``, ``voxel_batched_route``,
``flat_route``, ``bilinear_route``, ``bilinear_batched_route``,
``voxel_tiles_route``, ``bilinear_patches_route``),
never from a failure. The thresholds are measurements on an H100
(``scripts/tune_scatter_routes.py``). What they reflect: a float
``atomicAdd`` on shared memory is a compare-and-swap loop on this card
(``ATOMS.CAST.SPIN``), so updates of one pixel form a serial chain, while
the L2's float adds (``REDG.E.ADD.F32``) are native and need no answer; the
L2 takes ~77 G of them a second, and a ``float2`` or ``float4`` reduction
(``REDG.E.ADD.F32x2`` / ``.F32x4``) costs it no more than a scalar one.
Private tiles in shared memory win where the output outgrows the L2 or
where so many events share a pixel that the L2 serialises them; vector
reductions win where one event's taps can be made neighbours in memory and
the events are many; below that the direct kernels win.

- ``voxel_scatter:vector`` — from 262144 events on at 180x240 (later on
  larger sensors, never at 720p): both temporal taps of an event go as one
  ``float2`` reduction into a bins-innermost scratch, which a second kernel
  rearranges into the uninitialised ``(B, H, W)`` grid.
  ``voxel_scatter:direct`` — fewer events, or a scratch that would crowd
  the L2: two scalar reductions per event into the zeroed grid.
- ``voxel_scatter_batched:vector`` / ``:direct`` — the same two kernels
  with the row as the grid's y axis: S rows of N events into S grids (2S
  with the polarity split of the trainers' grids) in one launch, the vector
  route in chunks of rows whose scratch stays in the L2
  (``voxel_batched_chunk``), by ``voxel_batched_route``: the single
  grid's rule per row and per launch. The single grid's routes are these
  kernels at S = 1.
  ``voxel_scatter_batched:private`` — batches that the rule above sends
  'direct' whose grids hold at least ``PRIVATE_MIN_GRID_BYTES`` (32 MB,
  about two thirds of the L2) and whose bin plane fits 227 KB
  (``voxel_grids_fixed_n``'s 104 DAVIS240 windows): one block per (grid,
  bin) owns that plane in shared memory, reads its row's ``t_norm`` and
  keeps the taps of its bin and sign, and stores the plane once into the
  uninitialised grids: no memset, no global atomic. Fewer rows stay
  direct, and 'vector' keeps what it takes.
- ``flat_scatter:vector`` — two rows or more and enough ids (D = 2: from
  262144): the weights of one id go as one ``float2`` or as ``float4``
  reductions into a rows-innermost scratch, transposed by a second kernel.
  ``flat_scatter:direct`` — one row (the event image), or few ids: one
  thread per id, one scalar reduction per row into the zeroed output.

- ``bilinear_scatter:vector`` — K >= 2 channels past 227 KB with enough
  events (``vector_pays``: the timestamp image, zhu's grid levels): each
  tap's K values go as one ``float2``/``float4`` reduction into a zeroed
  channels-innermost scratch, which a second kernel unpacks into an
  uninitialised output; samples in chunks of ``vector_chunk``.
- ``bilinear_scatter:direct`` — one thread per event, global ``atomicAdd``
  into the zeroed output: what neither of the others wins (few events,
  one channel past 227 KB, few channels below the vector route's rule).
  A row-band splat for few events (one launch, no memset) lost to it and
  stays in ``scripts/tune_scatter_variants.cu``.
- ``bilinear_scatter:private`` — 98304 events or more into an image that
  fits: up to 132 blocks each accumulate a private copy in shared memory
  and add its non-zero pixels to the zeroed output.
- ``bilinear_scatter:single`` — the same kernel with one block, which
  stores its image into an uninitialised output. It measured slower than
  the direct route at every shape tried (one SM zeroing and storing the
  image costs more than a memset node), so no shape is sent to it; it stays
  selectable for measurement.
- ``bilinear_scatter_batched:private`` / ``:vector`` / ``:direct`` — S
  samples of N events each in one launch (up to 65535 samples) with the
  sample as the grid's y axis (Pallas batches ``_bilinear_kernel`` under
  ``vmap`` by adding a grid axis): the private kernel per sample where
  ``K*H*W*4`` bytes fit 227 KB, else the vector or direct one by
  ``bilinear_batched_route``; ``private_blocks`` gives the private blocks
  a sample by shape. The single image's routes
  are these kernels at S = 1.
- ``bilinear_patches_scatter`` — run ``q`` of ``C`` consecutive slots
  splats into patch ``q`` only (the batched patch loss of the ROI solvers):
  one block owns each patch in shared memory and stores it once into an
  uninitialised output, from 768 patches on.
  ``bilinear_patches_scatter:direct`` — one thread per slot, global atomics
  into the zeroed patches: fewer patches (their output stays in L2), and
  patches too large for shared memory.
- ``patch_variance_vg`` (``csrc/patch_loss_kernels.cu``; no TPU kernel,
  the JAX package composes it from ``bilinear_matmul`` and XLA ops) — one
  whole evaluation of the ROI solvers' patch loss for the variance
  objective under the linear-velocity warp, its value and its gradient in
  the velocity: one block per ROI warps its slots, splats them into a
  patch in shared memory, blurs, sums and, for the gradient, blurs back and
  gathers. ``events_cmax.make_patch_loss`` takes it where
  ``fused_patch_variance`` says so.

Private copies summed across a thread-block cluster through distributed
shared memory, each pixel stored once, lost to these kernels on the card
(``scripts/tune_scatter_variants.cu``): for whole images to more private
blocks a sample run in waves, for few patches to the direct kernel.
- ``voxel_tiles_scatter:private`` — one block per ``(tile, bin)`` owns that
  bin plane in shared memory, reads its tile's slots and keeps the taps of
  its bin, and stores the plane once into an uninitialised output.
  ``voxel_tiles_scatter:direct`` (global atomics) serves bin planes too
  large for shared memory.

Each wrapper launches its kernel when its tensors lie on the card and adds
one to its route's count when it does, and only then (``launch_counts``).
For tensors on the CPU it runs its plain PyTorch version (``*_plain``,
``index_add_`` based) instead: that is what the CPU tests run, and nothing
on the main path calls the plain version when a card is present. There is
no fallback: on a CUDA tensor a wrapper launches or raises.

The drivers keep the JAX names and preprocessing (``voxel_matmul``,
``voxel_matmul_tiles``, ``image_matmul``, ``bilinear_matmul``;
``scatter_add_flat_cuda`` stands for ``scatter_add_flat_pallas``) so that
each has one counterpart to be held against. ``precision`` is accepted with
the JAX values ('hilo', 'bf16', 'int8') and every kernel computes in f32,
which lies inside each of those precision classes. The VMEM planning of the
JAX wrappers (``_fit_chunk``, ``SensorLimitError``, the oversized-sensor
fallbacks) has no counterpart: the card has no such limit.

Gradients: ``voxel_matmul``, ``voxel_matmul_batched``, ``bilinear_matmul``,
``bilinear_matmul_batched`` and ``bilinear_patches_scatter`` are ``torch.autograd.Function``s whose backward
is the plain-torch gather of ``_voxel_core_bwd`` / ``_bilinear_core_bwd``
(plain jnp in the JAX package, so plain torch here); the flat scatter's
backward is a gather too.

Float atomics accumulate in a run-dependent order, so results agree with
the plain version to about 1e-6 of the grid scale, not bitwise (see
``ops.scatter`` for the deterministic 'sort' route).

Launches are asynchronous on PyTorch's current stream. A temporary input
freed right after a launch goes back to PyTorch's caching allocator, whose
reuse is ordered on that same stream, so a kernel never reads freed memory.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..errors import ConfigurationError
from . import build
from .blur import zero_pad_blur

PRECISIONS = ("hilo", "bf16", "int8")

_F32 = torch.float32
_I32 = torch.int32


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ConfigurationError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")


def _check(name: str, tensors, dtypes) -> torch.device:
    """Device, type and contiguity checks of a kernel wrapper's inputs."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ConfigurationError(
                f"{name}: inputs on different devices ({t.device} vs {dev})")
        if t.dtype != dt:
            raise ConfigurationError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ConfigurationError(f"{name}: inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ConfigurationError(f"{name}: unsupported device {dev}")
    return dev


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# The most dynamic shared memory one block can have on an H100 (227 KB).
SHARED_MAX_BYTES = 232448

ROUTES = ("voxel_scatter:vector", "voxel_scatter:direct",
          "voxel_scatter_batched:vector", "voxel_scatter_batched:direct",
          "voxel_scatter_batched:private",
          "voxel_tiles_scatter:private", "voxel_tiles_scatter:direct",
          "flat_scatter:vector", "flat_scatter:direct",
          "bilinear_scatter:direct", "bilinear_scatter:private",
          "bilinear_scatter:single", "bilinear_scatter:vector",
          "bilinear_scatter_batched:private",
          "bilinear_scatter_batched:direct",
          "bilinear_scatter_batched:vector", "bilinear_patches_scatter",
          "bilinear_patches_scatter:direct", "patch_variance_vg")
_launches = dict.fromkeys(ROUTES, 0)


def _pick(name: str, route, chosen: str, allowed) -> str:
    """The route of a call: the one chosen from its shape, or the caller's
    ``route`` where this shape allows it (for timing one route against
    another); a route the shape does not allow raises."""
    if route is None:
        return chosen
    if route not in allowed:
        raise ConfigurationError(
            f"{name}: route {route!r} does not serve this shape "
            f"(allowed: {sorted(allowed)})")
    return route


# ---------------------------------------------------------------------------
# Voxel grid (replaces _voxel_kernel, pallas_scatter.py:113)
# ---------------------------------------------------------------------------

def voxel_scatter_plain(xs, ys, t_norm, ps, B: int, H: int, W: int):
    """Plain version of ``voxel_scatter``: the same two temporal taps per
    event, summed with ``index_add_``."""
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    ok_ev = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H) & (ps != 0)
    pix = ys.long() * W + xs.long()
    out = torch.zeros(B * H * W, dtype=_F32, device=xs.device)
    for b, wt in ((b0, ps * (1.0 - fb)), (b0 + 1.0, ps * fb)):
        ok = ok_ev & (b >= 0) & (b < B)
        idx = torch.where(ok, b, 0.0).long() * (H * W) + torch.where(ok, pix, 0)
        out.index_add_(0, idx, torch.where(ok, wt, 0.0))
    return out.view(B, H, W)


# Where the vector routes pay, from scripts/tune_scatter_routes.py on an H100
# (parts 6-8). A vector reduction costs the L2 one request whatever its width
# (~77 G requests/s for scalars, float2s and float4s alike), so a vector
# route saves one request per event (voxel) or per id and spared row (flat);
# against that it zeroes a scratch, keeps it in L2 and runs a second pass
# over it. With 262144 requests saved the routes break even (voxel at
# 180x240: 0.0097 against 0.0099 ms; flat, D = 2: 0.0089 against 0.0101), at
# 131072 they lose, from 524288 they win by 15-40%. The scratch may hold four
# floats per saved request (VGA, 3.7M floats: lost at 524288 events, won at
# 2^20) and must stay in L2 beside the output (720p, 44 MB: lost at every
# count, 0.121 against 0.061 ms at 2^21 events).
VECTOR_MIN_SAVED = 262144
VECTOR_SCRATCH_PER_SAVED = 4
VECTOR_MAX_SCRATCH_BYTES = 16 << 20


def _vector_pays(saved: int, scratch_floats: int) -> bool:
    return (saved >= VECTOR_MIN_SAVED
            and scratch_floats <= VECTOR_SCRATCH_PER_SAVED * saved
            and scratch_floats * 4 <= VECTOR_MAX_SCRATCH_BYTES)


def _voxel_scratch_bins(B: int) -> int:
    """Columns of one bins-innermost accumulator: even, and past the last
    pair of either parity (B + 1 for odd B, B + 2 for even B)."""
    return (B + 2) & ~1


def voxel_route(n: int, B: int, H: int, W: int) -> str:
    """Route of a (B, H, W) voxel grid of n events: 'vector' where one
    reduction saved per event outweighs the two scratch accumulators (from
    262144 events on at 180x240, from ~920k at VGA, never at 720p), else
    'direct'."""
    scratch = 2 * H * W * _voxel_scratch_bins(B)
    return "vector" if _vector_pays(n, scratch) else "direct"


def voxel_scatter(xs, ys, t_norm, ps, B: int, H: int, W: int, route=None):
    """(B, H, W) temporally-bilinear voxel grid of preprocessed events.

    ``xs``/``ys`` int32 in-image coordinates, ``t_norm`` f32 in [0, B-1],
    ``ps`` f32 weights (0 for dropped events) — what ``voxel_matmul``
    hands over; events in any order. Launches a CUDA kernel for CUDA
    tensors; the plain version for CPU tensors.

    Routes, by shape alone (``voxel_route``). 'vector', for many events on
    a grid whose scratch stays small beside them: each event sends both
    temporal taps as one ``float2`` reduction into one of two zeroed
    bins-innermost accumulators ``(H*W, Bp)`` (even and odd first bins, so
    that every pair is 8-byte aligned), and a second kernel adds the two
    into an uninitialised ``(B, H, W)`` grid. 'direct' otherwise: two scalar
    reductions per event into the zeroed grid, one kernel. ``route`` forces
    either.
    """
    dev = _check("voxel_scatter", (xs, ys, t_norm, ps), (_I32, _I32, _F32, _F32))
    n = xs.shape[0]
    route = _pick("voxel_scatter", route, voxel_route(n, B, H, W),
                  {"vector", "direct"})
    if dev.type == "cpu":
        return voxel_scatter_plain(xs, ys, t_norm, ps, B, H, W)
    if n == 0 or B == 0:
        return torch.zeros((B, H, W), dtype=_F32, device=dev)
    ptrs = (xs.data_ptr(), ys.data_ptr(), t_norm.data_ptr(), ps.data_ptr())
    if route == "vector":
        Bp = _voxel_scratch_bins(B)
        acc = torch.zeros((2, H * W, Bp), dtype=_F32, device=dev)
        if acc.data_ptr() % 8:
            raise ConfigurationError(
                "voxel_scatter: scratch not aligned for float2 reductions")
        out = torch.empty((B, H, W), dtype=_F32, device=dev)
        rc = build.library().voxel_scatter_vector(
            *ptrs, n, B, H, W, Bp, acc.data_ptr(), out.data_ptr(), _stream())
    else:
        out = torch.zeros((B, H, W), dtype=_F32, device=dev)
        rc = build.library().voxel_scatter(
            *ptrs, n, B, H, W, out.data_ptr(), _stream())
    build.check(rc, f"voxel_scatter:{route}")
    _launches[f"voxel_scatter:{route}"] += 1
    return out


class _VoxelCore(torch.autograd.Function):
    """Voxel scatter with the gather VJP of ``_voxel_core_bwd``
    (pallas_scatter.py:469): cotangents reach ``t_norm`` and ``ps``; the
    integer coordinates get none."""

    @staticmethod
    def forward(ctx, xs, ys, t_norm, ps, B, H, W):
        ctx.save_for_backward(xs, ys, t_norm, ps)
        ctx.dims = (B, H, W)
        return voxel_scatter(xs, ys, t_norm, ps, B, H, W)

    @staticmethod
    def backward(ctx, g):
        xs, ys, t_norm, ps = ctx.saved_tensors
        g_t, g_ps = _voxel_vjp(g.reshape(1, -1), xs[None], ys[None],
                               t_norm[None], ps[None], *ctx.dims, False)
        return None, None, g_t[0], g_ps[0], None, None, None


def voxel_matmul(xs, ys, ts, ps, B: int, sensor_size=(180, 240),
                 precision: str = "hilo", mask=None, t0=None, t1=None):
    """(B, H, W) temporally-bilinear voxel grid (``voxel_matmul``,
    pallas_scatter.py:236) through the CUDA voxel kernel.

    Matches ``events_to_voxel(..., temporal_bilinear=True)`` with integer
    spatial coordinates. Out-of-image events are dropped; masked events
    contribute nothing; ``t0``/``t1`` default to the first and last *valid*
    event, and out-of-window events under an override are pinned to the
    edge bin with their surviving tap folded into ``ps``
    (pallas_scatter.py:259-311). The JAX kernel requires time-sorted
    events; this kernel does not, but callers keep the precondition.
    ``precision`` ('hilo', 'bf16', 'int8') is accepted for parity; the
    kernel computes in f32, inside every one of those classes.
    Differentiable in ``ts`` and ``ps``. Inputs are tensors on one device.
    """
    _check_precision(precision)
    H, W = sensor_size
    if xs.shape[0] == 0:
        return torch.zeros((B, H, W), dtype=_F32, device=xs.device)
    xs, ys, t_norm, ps = voxel_inputs(xs, ys, ts, ps, B, sensor_size,
                                      mask=mask, t0=t0, t1=t1)
    return _VoxelCore.apply(xs, ys, t_norm, ps, B, H, W)


def voxel_inputs(xs, ys, ts, ps, B: int, sensor_size, mask=None, t0=None,
                 t1=None):
    """``voxel_matmul``'s preprocessing: the ``(xs, ys, t_norm, ps)`` that
    the voxel kernel takes (int32 in-image coordinates, f32 bin coordinate
    in [0, B-1], f32 weights with dropped events at 0): the one-row case
    of ``voxel_inputs_batched``. Differentiable in ``ts`` and ``ps``."""
    if mask is not None:
        mask = torch.as_tensor(mask, device=xs.device)[None]
    args = voxel_inputs_batched(xs[None], ys[None], ts[None], ps[None], B,
                                sensor_size, mask=mask, t0=t0, t1=t1)
    return tuple(a[0] for a in args)


# ---------------------------------------------------------------------------
# Batched voxel grids (replaces _voxel_kernel under jax.vmap: Pallas adds a
# grid axis for the batch, pallas_scatter.py:113 / call :353)
# ---------------------------------------------------------------------------

def _voxel_row_scratch(B: int, H: int, W: int, split: bool) -> int:
    """Floats of one row's vector scratch: two bins-innermost accumulators
    of its grid (of each of its two grids with ``split``)."""
    return (2 if split else 1) * 2 * H * W * _voxel_scratch_bins(B)


def voxel_batched_chunk(B: int, H: int, W: int, split: bool = False) -> int:
    """Rows that one launch of ``voxel_scatter_batched:vector`` takes: as
    many as keep its scratch within ``VECTOR_MAX_SCRATCH_BYTES`` (in the
    50 MB L2 beside the grids; 21 at 128x128 with B = 5, 8 at 180x240), at
    least one, at most ``BATCH_MAX_SAMPLES``."""
    per = _voxel_row_scratch(B, H, W, split) * 4
    return max(1, min(BATCH_MAX_SAMPLES, VECTOR_MAX_SCRATCH_BYTES // per))


def voxel_private_fits(H: int, W: int) -> bool:
    """Whether one (H, W) bin plane fits one block's shared memory, as
    ``voxel_scatter_batched:private`` needs."""
    return H * W * 4 <= SHARED_MAX_BYTES


# Where the batched private route pays, from part 12 of
# scripts/tune_scatter_routes.py on an H100 (its "rule" rows): once the
# grids pass 32 MB, about two thirds of the 50 MB L2, where the direct
# route's memset and reductions reach device memory. At 33 MB (40 DAVIS240
# grids) private took 0.0195 / 0.0301 / 0.0598 ms against direct's 0.0228
# / 0.0503 / 0.1029 at 4,096 / 20,000 / 65,536 events a row, at 40 MB (64
# split rows into 128x128) 0.0285 / 0.0396 / 0.1138 against 0.0311 /
# 0.0555 / 0.1418 (4,096 / 12,288 / 65,536); 104 DAVIS240 grids (86 MB)
# of 20,000 events 0.0618 against 0.1596, where direct in chunks of rows
# that stay in the L2 took 0.1004. Below 32 MB direct still wins at few
# events a row: 30 MB (48 split rows), 4,096 events 0.0195 against 0.0212;
# 26 MB (32 DAVIS240 grids) 0.0151 against 0.0175; 25 MB (40 split rows)
# 0.0144 against 0.0182 and 0.0233 against 0.0266 at 12,288. The trainers'
# eight rows (5-14 MB) stay direct: each of their 40-80 blocks reads a
# whole row, and its reads' latency outlasts the direct route's memset and
# reductions in the L2 (fit's 8 x 32,768 at 184x240: 0.0168 against
# 0.0126). The vector route keeps every batch it takes: at 32 DAVIS240
# windows of 2^18 it took 0.1936 ms against private's 0.2303.
PRIVATE_MIN_GRID_BYTES = 32 << 20


def voxel_batched_route(S: int, n: int, B: int, H: int, W: int,
                        split: bool = False) -> str:
    """Route of S rows of n events into S grids (2S with ``split``):
    ``voxel_route``'s rule per row and per launch, 'vector' where a row's
    scratch stays within ``VECTOR_MAX_SCRATCH_BYTES`` and within
    ``VECTOR_SCRATCH_PER_SAVED`` floats per event, and one launch's rows
    hold ``VECTOR_MIN_SAVED`` events. Where that rule says 'direct',
    'private' if the bin plane fits a block's shared memory
    (``voxel_private_fits``) and the grids hold at least
    ``PRIVATE_MIN_GRID_BYTES``; never for one grid (S = 1 without
    ``split``), which keeps ``voxel_route``."""
    scratch = _voxel_row_scratch(B, H, W, split)
    rows = min(S, voxel_batched_chunk(B, H, W, split))
    if (scratch * 4 <= VECTOR_MAX_SCRATCH_BYTES
            and scratch <= VECTOR_SCRATCH_PER_SAVED * n
            and rows * n >= VECTOR_MIN_SAVED):
        return "vector"
    grids = S * (2 if split else 1)
    return ("private" if (S > 1 or split) and voxel_private_fits(H, W)
            and grids * B * H * W * 4 >= PRIVATE_MIN_GRID_BYTES
            else "direct")


def voxel_scatter_batched_plain(xs, ys, t_norm, ps, B: int, H: int, W: int,
                                split: bool = False):
    """Plain version of ``voxel_scatter_batched``: each temporal tap of all
    rows summed with one ``index_add_`` over ids offset by the event's grid
    (its row's; with ``split`` its row's positive grid for ``ps > 0``,
    negative for ``ps < 0``, weight ``|ps|``). Every grid receives its terms
    in ``voxel_scatter_plain``'s order, so it equals S (2S) calls of that
    bit for bit."""
    S, n = xs.shape
    G = 2 if split else 1
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    ok_ev = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H) & (ps != 0)
    grid = torch.arange(S, device=xs.device)[:, None] * G
    w = ps
    if split:
        grid = grid + (ps < 0).long()
        w = ps.abs()
    pix = ys.long() * W + xs.long()
    out = torch.zeros(S * G * B * H * W, dtype=_F32, device=xs.device)
    for b, wt in ((b0, w * (1.0 - fb)), (b0 + 1.0, w * fb)):
        ok = ok_ev & (b >= 0) & (b < B)
        idx = (grid * (B * H * W) + torch.where(ok, b, 0.0).long() * (H * W)
               + torch.where(ok, pix, 0))
        out.index_add_(0, idx.reshape(-1),
                       torch.where(ok, wt, 0.0).reshape(-1))
    return out.view(S, G * B, H, W)


def voxel_scatter_batched(xs, ys, t_norm, ps, B: int, H: int, W: int,
                          split: bool = False, route=None):
    """(S, B, H, W) voxel grids of S rows of preprocessed events: grid ``s``
    is ``voxel_scatter(xs[s], ys[s], t_norm[s], ps[s], B, H, W)``. With
    ``split`` (S, 2B, H, W): row s's events with ``ps > 0`` make its first B
    channels, those with ``ps < 0`` the last B, each with weight ``|ps|``
    (``voxel_inputs_batched(split=True)`` encodes the polarity so).

    ``xs``/``ys`` int32, ``t_norm``/``ps`` f32, all ``(S, N)`` and
    contiguous: what ``voxel_inputs_batched`` hands over. CUDA tensors
    launch a kernel with the row as the grid's y axis; CPU tensors run
    ``voxel_scatter_batched_plain``.

    Routes, by shape alone (``voxel_batched_route``). 'private', for
    grids that outgrow two thirds of the L2 and whose bin plane fits a
    block's shared memory: one block per (grid, bin) owns that plane in
    shared memory, keeps the taps of its bin and sign, and stores the
    plane once into the uninitialised grids: no memset, no global atomic,
    one launch per ``BATCH_MAX_SAMPLES`` rows. The single grid's two with a row offset:
    'direct', two scalar reductions per event into the zeroed grids, one
    launch per ``BATCH_MAX_SAMPLES`` rows; 'vector', one ``float2``
    reduction per event into its grid's two zeroed bins-innermost
    accumulators and a second kernel that adds them into the uninitialised
    grids, launched in chunks of ``voxel_batched_chunk`` rows so that the
    scratch stays in the L2. ``route`` forces any of them ('private' only
    where the plane fits; elsewhere it raises ``ConfigurationError``).
    """
    dev = _check("voxel_scatter_batched", (xs, ys, t_norm, ps),
                 (_I32, _I32, _F32, _F32))
    if xs.dim() != 2 or any(a.shape != xs.shape for a in (ys, t_norm, ps)):
        raise ConfigurationError(
            "voxel_scatter_batched: inputs must share one (S, N) shape")
    S, n = xs.shape
    allowed = {"vector", "direct"}
    if voxel_private_fits(H, W):
        allowed.add("private")
    route = _pick("voxel_scatter_batched", route,
                  voxel_batched_route(S, n, B, H, W, split), allowed)
    if dev.type == "cpu":
        return voxel_scatter_batched_plain(xs, ys, t_norm, ps, B, H, W, split)
    G = 2 if split else 1
    if S == 0 or n == 0 or B == 0:
        return torch.zeros((S, G * B, H, W), dtype=_F32, device=dev)
    lib = build.library()
    if route == "private":
        chunk = BATCH_MAX_SAMPLES
        out = torch.empty((S, G * B, H, W), dtype=_F32, device=dev)
    elif route == "vector":
        Bp = _voxel_scratch_bins(B)
        chunk = voxel_batched_chunk(B, H, W, split)
        acc = torch.zeros((min(S, chunk) * G, 2, H * W, Bp), dtype=_F32,
                          device=dev)
        if acc.data_ptr() % 8:
            raise ConfigurationError("voxel_scatter_batched: scratch not "
                                     "aligned for float2 reductions")
        out = torch.empty((S, G * B, H, W), dtype=_F32, device=dev)
    else:
        chunk = BATCH_MAX_SAMPLES
        out = torch.zeros((S, G * B, H, W), dtype=_F32, device=dev)
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        ptrs = (xs[s0:s1].data_ptr(), ys[s0:s1].data_ptr(),
                t_norm[s0:s1].data_ptr(), ps[s0:s1].data_ptr(), s1 - s0, n,
                B, H, W, int(split))
        if route == "private":
            rc = lib.voxel_scatter_batched_private(
                *ptrs, out[s0:s1].data_ptr(), _stream())
        elif route == "vector":
            if s0:
                acc.zero_()
            rc = lib.voxel_scatter_batched_vector(
                *ptrs, Bp, acc.data_ptr(), out[s0:s1].data_ptr(), _stream())
        else:
            rc = lib.voxel_scatter_batched(*ptrs, out[s0:s1].data_ptr(),
                                           _stream())
        build.check(rc, f"voxel_scatter_batched:{route}")
        _launches[f"voxel_scatter_batched:{route}"] += 1
    return out


class _VoxelBatchedCore(torch.autograd.Function):
    """Batched voxel scatter with the gather VJP of ``_voxel_core_bwd``
    (pallas_scatter.py:469) per row: cotangents reach ``t_norm`` and
    ``ps``, as in ``_VoxelCore``; with ``split`` each event reads its own
    grid's cotangent, and ``ps``'s carries the sign of its encoding."""

    @staticmethod
    def forward(ctx, xs, ys, t_norm, ps, B, H, W, split):
        ctx.save_for_backward(xs, ys, t_norm, ps)
        ctx.dims = (B, H, W, split)
        return voxel_scatter_batched(xs, ys, t_norm, ps, B, H, W, split=split)

    @staticmethod
    def backward(ctx, g):
        xs, ys, t_norm, ps = ctx.saved_tensors
        g_t, g_ps = _voxel_vjp(g.reshape(g.shape[0], -1), xs, ys, t_norm, ps,
                               *ctx.dims)
        return None, None, g_t, g_ps, None, None, None, None


def _voxel_vjp(g, xs, ys, t_norm, ps, B: int, H: int, W: int, split: bool):
    """Gather VJP of ``_voxel_core_bwd`` (pallas_scatter.py:469) for S rows
    of kernel inputs ``(S, N)``, ``g`` the grids' cotangent as ``(S, G*B*H*W)``:
    the cotangents of ``t_norm`` and ``ps``. With ``split`` an event reads
    its own grid's cotangent and ``ps``'s carries the sign of its
    encoding."""
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    ib0 = torch.where(torch.isfinite(b0), b0, -1.0).clamp(-1, B).long()
    pix = ys.long().clamp(0, H - 1) * W + xs.long().clamp(0, W - 1)
    mag, sign, first = ps, 1.0, 0
    if split:
        neg = ps < 0
        mag, sign = ps.abs(), torch.where(neg, -1.0, 1.0)
        first = neg.long() * B

    def tap_cot(ib):
        ok = (ib >= 0) & (ib < B)
        idx = (first + ib.clamp(0, B - 1)) * (H * W) + pix
        return torch.where(ok, torch.gather(g, 1, idx), 0.0)

    g0 = tap_cot(ib0)
    g1 = tap_cot(ib0 + 1)
    return mag * (g1 - g0), sign * ((1.0 - fb) * g0 + fb * g1)


def voxel_inputs_batched(xs, ys, ts, ps, B: int, sensor_size, mask=None,
                         t0=None, t1=None, split: bool = False):
    """``voxel_matmul``'s preprocessing of S rows (pallas_scatter.py:259-311
    under ``vmap``): the ``(xs, ys, t_norm, ps)`` that the batched voxel
    kernel takes, ``(S, N)`` each (int32 in-image coordinates, f32 bin
    coordinate in [0, B-1], f32 weights with out-of-image and masked events
    at 0). ``mask`` (S, N); ``t0``/``t1`` scalars or per-row ``(S,)``
    overrides. Without an override a row's window is its first and last
    stamp (``ts[:, 0]``, ``ts[:, -1]``), or with a mask its masked min and
    max, one reduction over all rows each (JAX's voxel_grid.py:107-115).
    Under an override, out-of-window events are pinned to the edge bin with
    their surviving tap folded into the weight, as the JAX driver does
    (its kernel's per-chunk bin classification needs it; here it keeps the
    two drivers' outputs and VJPs the same function). ``split``: each event
    weighs 1 (times the mask and the fold) with the sign of its polarity,
    positive for ``ps > 0`` and negative otherwise, as
    ``events_to_neg_pos_voxel`` weighs them. Differentiable in ``ts`` and
    ``ps``."""
    H, W = sensor_size
    dev = xs.device
    xs = xs.to(_I32)
    ys = ys.to(_I32)
    ts = ts.to(_F32)
    ps = ps.to(_F32)
    in_img = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    w = torch.where(in_img, torch.ones_like(ps) if split else ps, 0.0)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
        w = w * mask.to(_F32)
    xs = xs.clamp(0, W - 1).contiguous()
    ys = ys.clamp(0, H - 1).contiguous()

    if t0 is None or t1 is None:
        if mask is None:
            tt0, tt1 = ts[:, 0], ts[:, -1]
        else:
            valid = mask != 0
            big = 3.4e38
            tt0 = torch.where(valid, ts, big).amin(1)
            tt1 = torch.where(valid, ts, -big).amax(1)
        t0 = tt0 if t0 is None else t0
        t1 = tt1 if t1 is None else t1
    t0 = torch.as_tensor(t0, dtype=_F32, device=dev).reshape(-1, 1)
    t1 = torch.as_tensor(t1, dtype=_F32, device=dev).reshape(-1, 1)
    dt = t1 - t0
    t_norm = (ts - t0) / torch.where(dt == 0, 1.0, dt) * (B - 1)

    # out-of-window events (only under t0/t1 overrides)
    below = t_norm < 0.0
    above = t_norm > (B - 1.0)
    w = torch.where(below, w * torch.clamp(1.0 + t_norm, min=0.0), w)
    w = torch.where(above,
                    w * torch.clamp(1.0 - (t_norm - (B - 1.0)), min=0.0), w)
    t_norm = torch.where(below, 0.0, t_norm)
    t_norm = torch.where(above, float(B - 1), t_norm)
    if split:
        w = torch.where(ps > 0, w, -w)
    return xs, ys, t_norm.contiguous(), w.contiguous()


def voxel_matmul_batched(xs, ys, ts, ps, B: int, sensor_size=(180, 240),
                         precision: str = "hilo", mask=None, t0=None,
                         t1=None, split: bool = False):
    """(S, B, H, W) voxel grids of S rows of events through the batched
    CUDA voxel kernel: ``voxel_matmul`` under ``jax.vmap`` over the rows
    (JAX's ``voxel_grids_fixed_n``, voxel_grid.py:328, and the trainers'
    padded rows). ``split``: (S, 2B, H, W), each row's
    ``events_to_neg_pos_voxel`` grids one after the other, in one launch.

    ``xs``, ``ys``, ``ts``, ``ps`` ``(S, N)``; ``mask`` (S, N); ``t0``/``t1``
    scalars or ``(S,)``. Per row it is ``voxel_matmul``: out-of-image events
    dropped, masked events contribute nothing, the window defaults to the
    row's first and last valid event, out-of-window events under an
    override pinned to the edge bin. ``precision`` is accepted for parity;
    the kernel computes in f32. Differentiable in ``ts`` and ``ps``.
    """
    _check_precision(precision)
    H, W = sensor_size
    S, n = xs.shape
    if n == 0:
        return torch.zeros((S, (2 if split else 1) * B, H, W), dtype=_F32,
                           device=xs.device)
    args = voxel_inputs_batched(xs, ys, ts, ps, B, sensor_size, mask=mask,
                                t0=t0, t1=t1, split=split)
    return _VoxelBatchedCore.apply(*args, B, H, W, split)


# ---------------------------------------------------------------------------
# Per-tile voxel grids (replaces _voxel_kernel on the (tile, chunk) grid,
# voxel_matmul_tiles, pallas_scatter.py:364 / call :455)
# ---------------------------------------------------------------------------

def voxel_tiles_scatter_plain(bx, by, t_norm, bp, B: int, th: int, tw: int):
    """Plain version of ``voxel_tiles_scatter``: the two temporal taps of
    every slot, summed into its own tile with ``index_add_``."""
    T, cap = bx.shape
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    ok_ev = (bx >= 0) & (bx < tw) & (by >= 0) & (by < th) & (bp != 0)
    tile = torch.arange(T, device=bx.device)[:, None] * B
    pix = by.long() * tw + bx.long()
    out = torch.zeros(T * B * th * tw, dtype=_F32, device=bx.device)
    for b, wt in ((b0, bp * (1.0 - fb)), (b0 + 1.0, bp * fb)):
        ok = ok_ev & (b >= 0) & (b < B)
        idx = ((tile + torch.where(ok, b, 0.0).long()) * (th * tw)
               + torch.where(ok, pix, 0))
        out.index_add_(0, idx.reshape(-1), torch.where(ok, wt, 0.0)
                       .reshape(-1))
    return out.view(T, B, th, tw)


def voxel_tiles_route(B: int, th: int, tw: int) -> str:
    """'private' where one (th, tw) bin plane fits a block's shared memory
    (227 KB: up to (232, 250), say), else 'direct'."""
    return "private" if th * tw * 4 <= SHARED_MAX_BYTES else "direct"


def voxel_tiles_scatter(bx, by, t_norm, bp, B: int, th: int, tw: int,
                        route=None):
    """(T, B, th, tw) per-tile voxel grids of ``(T, cap)`` slots.

    ``bx``/``by`` int32 tile-local coordinates, ``t_norm`` f32 bin
    coordinate in [0, B-1] (dead slots -100), ``bp`` f32 weights (0 for
    dead slots) — what ``voxel_tiles_inputs`` hands over; slots need not be
    time-sorted. Launches a CUDA kernel for CUDA tensors; the plain version
    for CPU tensors.

    Routes, by shape alone (``voxel_tiles_route``): 'private' where a
    (th, tw) plane fits 227 KB of shared memory — one block per (tile, bin)
    reads its tile's slots, accumulates that plane in shared memory and
    stores it once into an uninitialised output (on an H100 faster than
    sending the taps through a cluster's distributed shared memory, which
    took 3-5 times as long: scripts/tune_scatter_routes.py); 'direct'
    otherwise — global atomics into a zeroed output. ``route`` forces one
    of the routes the shape allows.
    """
    dev = _check("voxel_tiles_scatter", (bx, by, t_norm, bp),
                 (_I32, _I32, _F32, _F32))
    if bx.dim() != 2 or any(a.shape != bx.shape for a in (by, t_norm, bp)):
        raise ConfigurationError(
            "voxel_tiles_scatter: inputs must share one (T, cap) shape")
    if dev.type == "cpu":
        return voxel_tiles_scatter_plain(bx, by, t_norm, bp, B, th, tw)
    T, cap = bx.shape
    if T == 0 or cap == 0 or B == 0:
        return torch.zeros((T, B, th, tw), dtype=_F32, device=dev)
    chosen = voxel_tiles_route(B, th, tw)
    route = _pick("voxel_tiles_scatter", route, chosen, {chosen, "direct"})
    ptrs = (bx.data_ptr(), by.data_ptr(), t_norm.data_ptr(), bp.data_ptr())
    if route == "private":
        out = torch.empty((T, B, th, tw), dtype=_F32, device=dev)
        rc = build.library().voxel_tiles_scatter_private(
            *ptrs, T, cap, B, th, tw, out.data_ptr(), _stream())
    else:
        out = torch.zeros((T, B, th, tw), dtype=_F32, device=dev)
        rc = build.library().voxel_tiles_scatter(
            *ptrs, T * cap, cap, B, th, tw, out.data_ptr(), _stream())
    build.check(rc, f"voxel_tiles_scatter:{route}")
    _launches[f"voxel_tiles_scatter:{route}"] += 1
    return out


def voxel_tiles_inputs(bx, by, bt, bp, B: int, tile, t0, t1, mask=None):
    """``voxel_matmul_tiles``' preprocessing (pallas_scatter.py:391-419):
    the ``(bx, by, t_norm, bp)`` that the per-tile kernel takes.

    Out-of-tile slots are dropped and ``mask`` multiplies the weights;
    coordinates are clipped into the tile; ``t_norm`` is taken over the
    shared window ``[t0, t1]``; out-of-window slots are pinned to the edge
    bin with their surviving tap folded into ``bp``; dead slots (weight 0)
    get the pad sentinel ``t_norm = -100``.
    """
    th, tw = tile
    dev = bx.device
    bx = bx.to(_I32)
    by = by.to(_I32)
    bt = bt.to(_F32)
    bp = bp.to(_F32)
    in_tile = (bx >= 0) & (bx < tw) & (by >= 0) & (by < th)
    bp = torch.where(in_tile, bp, 0.0)
    if mask is not None:
        bp = bp * torch.as_tensor(mask, device=dev).to(_F32)
    bx = bx.clamp(0, tw - 1).contiguous()
    by = by.clamp(0, th - 1).contiguous()
    t0 = torch.as_tensor(t0, dtype=_F32, device=dev)
    t1 = torch.as_tensor(t1, dtype=_F32, device=dev)
    dt = t1 - t0
    t_norm = (bt - t0) / torch.where(dt == 0, 1.0, dt) * (B - 1)
    below = t_norm < 0.0
    above = t_norm > (B - 1.0)
    bp = torch.where(below, bp * torch.clamp(1.0 + t_norm, min=0.0), bp)
    bp = torch.where(above,
                     bp * torch.clamp(1.0 - (t_norm - (B - 1.0)), min=0.0), bp)
    t_norm = torch.where(below, 0.0, t_norm)
    t_norm = torch.where(above, float(B - 1), t_norm)
    t_norm = torch.where(bp == 0.0, -100.0, t_norm)
    return bx, by, t_norm.contiguous(), bp.contiguous()


def voxel_matmul_tiles(bx, by, bt, bp, B: int, tile, t0, t1, mask=None,
                       precision: str = "hilo"):
    """Per-tile voxel grids of pre-bucketed events, one kernel launch
    (``voxel_matmul_tiles``, pallas_scatter.py:364).

    Inputs are ``(T, cap)`` tensors of tile-local coordinates with a shared
    window ``[t0, t1]``. Returns ``(T, B, th, tw)`` float32; the caller
    stitches the tiles. Forward only, as in JAX. ``precision`` is accepted
    for parity; the kernel computes in f32.
    """
    _check_precision(precision)
    th, tw = tile
    args = voxel_tiles_inputs(bx, by, bt, bp, B, tile, t0, t1, mask=mask)
    return voxel_tiles_scatter(*args, B, th, tw)


# ---------------------------------------------------------------------------
# Flat / image scatter (replaces _image_kernel, pallas_scatter.py:496)
# ---------------------------------------------------------------------------

def flat_scatter_plain(idx, w, num_buckets: int):
    """Plain version of ``flat_scatter`` (``index_add_`` along the buckets)."""
    ok = (idx >= 0) & (idx < num_buckets)
    ids = torch.where(ok, idx, 0).long()
    out = torch.zeros((w.shape[0], num_buckets), dtype=_F32, device=w.device)
    out.index_add_(1, ids, torch.where(ok[None, :], w, 0.0))
    return out


def _flat_scratch_rows(D: int) -> int:
    """Columns of the rows-innermost scratch: 2 for two rows (one float2
    per id), else D rounded up to whole float4s."""
    return 2 if D == 2 else -(-D // 4) * 4


def flat_route(D: int, n: int, num_buckets: int) -> str:
    """Route of a (D, num_buckets) flat scatter of n ids: 'vector' where
    the reductions saved (per id, D less the number of vector requests)
    outweigh the scratch (D = 2 into 181x241: from 262144 ids on), else
    'direct'. One row has nothing to pair."""
    Dp = _flat_scratch_rows(D)
    saved = n * (D - (1 if D == 2 else Dp // 4))
    return ("vector" if D >= 2 and _vector_pays(saved, num_buckets * Dp)
            else "direct")


def flat_scatter(idx, w, num_buckets: int, route=None):
    """(D, num_buckets) scatter-add: row d sums ``w[d]`` by bucket ``idx``.

    ``idx`` int32 (N,), ids outside ``[0, num_buckets)`` dropped; ``w`` f32
    (D, N). One wrapper call for all D rows.

    Routes, by shape alone (``flat_route``). 'vector', for D >= 2 and
    many ids: the D weights of an id go as one ``float2`` (D = 2) or
    as ``float4`` reductions (four rows each) into a zeroed rows-innermost
    scratch ``(num_buckets, Dp)``, which a second kernel transposes into an
    uninitialised output. 'direct' otherwise: one thread per id, one scalar
    reduction per row into the zeroed output. ``route`` forces one of the
    routes the shape allows (D = 1 allows 'direct' only).
    """
    dev = _check("flat_scatter", (idx, w), (_I32, _F32))
    if w.dim() != 2 or w.shape[1] != idx.shape[0]:
        raise ConfigurationError(
            f"flat_scatter: w must be (D, {idx.shape[0]}), got {tuple(w.shape)}")
    D, n = w.shape
    route = _pick("flat_scatter", route, flat_route(D, n, num_buckets),
                  {"vector", "direct"} if D >= 2 else {"direct"})
    if dev.type == "cpu":
        return flat_scatter_plain(idx, w, num_buckets)
    if n == 0 or D == 0 or num_buckets == 0:
        return torch.zeros((D, num_buckets), dtype=_F32, device=dev)
    if route == "vector":
        Dp = _flat_scratch_rows(D)
        scratch = torch.zeros((num_buckets, Dp), dtype=_F32, device=dev)
        if scratch.data_ptr() % 16:
            raise ConfigurationError(
                "flat_scatter: scratch not aligned for float4 reductions")
        out = torch.empty((D, num_buckets), dtype=_F32, device=dev)
        rc = build.library().flat_scatter_vector(
            idx.data_ptr(), w.data_ptr(), n, D, num_buckets, Dp,
            scratch.data_ptr(), out.data_ptr(), _stream())
    else:
        out = torch.zeros((D, num_buckets), dtype=_F32, device=dev)
        rc = build.library().flat_scatter(
            idx.data_ptr(), w.data_ptr(), n, D, num_buckets, out.data_ptr(),
            _stream())
    build.check(rc, f"flat_scatter:{route}")
    _launches[f"flat_scatter:{route}"] += 1
    return out


class _FlatScatter(torch.autograd.Function):
    """Flat scatter with its adjoint, a gather of the cotangent."""

    @staticmethod
    def forward(ctx, idx, w, num_buckets):
        ctx.save_for_backward(idx)
        ctx.num_buckets = num_buckets
        return flat_scatter(idx, w, num_buckets)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        ok = (idx >= 0) & (idx < ctx.num_buckets)
        g_w = torch.where(ok[None, :], g[:, torch.where(ok, idx, 0).long()],
                          0.0)
        return None, g_w, None


def scatter_add_flat_cuda(idx, w, num_buckets: int, precision: str = "hilo"):
    """Flat scatter-add through the CUDA flat kernel — the counterpart of
    ``scatter_add_flat_pallas`` (pallas_scatter.py:784), which views the
    buckets as a 128-wide image for the TPU's image kernel; the card needs
    no such view. ``w`` is (N,) or (D, N); the result is (num_buckets,) or
    (D, num_buckets). Out-of-range ids are dropped."""
    _check_precision(precision)
    single = w.dim() == 1
    w2 = (w[None, :] if single else w).to(_F32).contiguous()
    out = _FlatScatter.apply(idx.to(_I32).contiguous(), w2, num_buckets)
    return out[0] if single else out


def image_matmul(ix, iy, w, shape: Tuple[int, int], precision: str = "hilo"):
    """(H, W) integer scatter-add (``image_matmul``, pallas_scatter.py:529)
    through the CUDA flat kernel with ids ``iy*W + ix``; ids outside the
    image are dropped. Unsorted events are fine."""
    H, W = shape
    ix = ix.long()
    iy = iy.long()
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.where(ok, iy * W + ix, -1)
    return scatter_add_flat_cuda(flat, w, H * W, precision).view(H, W)


# ---------------------------------------------------------------------------
# Bilinear splat (replaces _bilinear_kernel, pallas_scatter.py:576)
# ---------------------------------------------------------------------------

def _bilinear_taps(x, y, H: int, W: int):
    """Floor, fractions, and for each of the 4 taps (oy, ox) its validity
    and flat pixel id (0 where invalid). Bounds are tested in float, so
    NaN and huge coordinates are dropped before any integer cast."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    taps = []
    for oy in (0, 1):
        for ox in (0, 1):
            xx = x0 + ox
            yy = y0 + oy
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            pix = (torch.where(ok, yy, 0.0).long() * W
                   + torch.where(ok, xx, 0.0).long())
            taps.append((oy, ox, ok, pix))
    return x - x0, y - y0, taps


def bilinear_scatter_plain(x, y, w, H: int, W: int):
    """Plain version of ``bilinear_scatter``: tap (y0+oy, x0+ox) gets
    ``(w * wx) * wy``, the kernel's order of products."""
    dx, dy, taps = _bilinear_taps(x, y, H, W)
    wx = (1.0 - dx, dx)
    wy = (1.0 - dy, dy)
    out = torch.zeros((w.shape[0], H * W), dtype=_F32, device=w.device)
    for oy, ox, ok, pix in taps:
        val = (w * wx[ox][None, :]) * wy[oy][None, :]
        out.index_add_(1, pix, torch.where(ok[None, :], val, 0.0))
    return out.view(-1, H, W)


# Routes of the whole-image splat, from scripts/tune_scatter_routes.py on an
# H100: at 181x241 the direct kernel wins at 65536 events and the private
# one at 131072. One private block per 1024 events, at most one per SM (132).
PRIVATE_MIN_EVENTS = 98304
PRIVATE_EVENTS_PER_BLOCK = 1024
PRIVATE_MAX_BLOCKS = 132
# Blocks a sample where one block a sample leaves SMs idle, in waves: at
# most 3 (part 9 of the tune script on an H100 at 700 W, 181x241 images:
# 83 x 200k events 0.293 ms with 1 block a sample, 0.305 with 2, 0.216
# with 3, 0.248 with 4, 0.234 with 6; 167 x 100k 0.302 / 0.252 / 0.236 /
# 0.270 / 0.268; 129 x 130k best with 1, 0.199), and only where they cut
# the waves per block's share of the events to 3/4 of one block's or less:
# both shapes cut them to 2/3 and gained 22-26%, the flush of the added
# copies costing 7-11% of the one-block time.
PRIVATE_WAVE_BLOCKS = 3
PRIVATE_WAVE_CUT = 0.75


def private_blocks(S: int, n: int) -> int:
    """Blocks a sample of the batched private kernel for S samples of n
    events, by shape. Up to 66 samples: as many as fill the card's 132 SMs
    in one wave (at most one per 1024 events). More, with at least 98304
    events a sample: 1 to ``PRIVATE_WAVE_BLOCKS``, the count that runs the
    fewest waves of blocks per block's share of the events (the smaller on
    a tie: each further block adds its copy's flush), where that is at
    most ``PRIVATE_WAVE_CUT`` of one block's waves. Otherwise one, which
    stores its image without a memset."""
    most = max(1, -(-n // PRIVATE_EVENTS_PER_BLOCK))
    if 2 * S <= PRIVATE_MAX_BLOCKS:
        return min(most, PRIVATE_MAX_BLOCKS // S)
    if n < PRIVATE_MIN_EVENTS:
        return 1
    share = lambda b: -(-S * b // PRIVATE_MAX_BLOCKS) / b
    best = min(range(1, min(most, PRIVATE_WAVE_BLOCKS) + 1),
               key=lambda b: (share(b), b))
    return best if share(best) <= PRIVATE_WAVE_CUT * share(1) else 1


# Many events into K >= 2 channels past shared memory: the vector route.
# Part 11 of scripts/tune_scatter_routes.py and chip_smoke.py on an H100
# (700 W): it pays where it saves at least VECTOR_MIN_SAVED_BILINEAR L2
# requests and its scratch holds at most VECTOR_SCRATCH_PER_SAVED floats per
# request saved, the rule of the voxel and flat vector routes with a lower
# floor (one image at 181x241, K = 4: direct 0.0064 against vector 0.0071
# ms at visualization's 15,000 events, 0.0083 against 0.0065 at 20,000,
# 0.0315 against 0.0223 at the 200k timestamp image; 25 samples: direct
# 0.0178 against 0.0229 at 2048 events a sample, 0.0275 against 0.0260 at
# 4096; 480x640: direct up to 20,000 events, vector from 32768). One
# private plane per (sample, channel) in shared memory lost at one image
# (0.2468 against 0.0153 ms), tied at zhu's level (0.2612 against 0.2642)
# and won at 83 samples (0.7705 against 0.8815: a loss chunk, as a
# landscape of zhu's objective would send; no path of chip_smoke.py does).
# One launch takes up to as many samples as keep its scratch within
# VECTOR_CHUNK_BYTES (30 at 181x241, K = 4): a loss chunk of 83 x 200k
# into 181x241 took 0.9034 / 0.8905 / 0.8781 / 0.8843 / 0.9185 ms in
# launches of 10 / 21 / 30 / 42 / 83 samples, zhu's grid level (25 x 200k)
# 0.3881 / 0.3021 / 0.2834 / 0.2735 / 0.2722 / 0.2664 in launches of 1 / 3
# / 5 / 9 / 13 / 25.
VECTOR_MIN_SAVED_BILINEAR = 3 * 65536
VECTOR_CHUNK_BYTES = 20 << 20


def vector_channels(K: int) -> int:
    """Columns of the channels-innermost scratch: 2 for two channels (one
    float2 a tap), else K rounded up to whole float4s."""
    return 2 if K == 2 else -(-K // 4) * 4


def vector_pays(K: int, H: int, W: int, n: int, S: int = 1) -> bool:
    """Whether the vector route pays for S samples of n events: the L2
    requests it saves (4 taps an event, each ``K - Kp/4`` requests fewer;
    one fewer for K = 2) reach ``VECTOR_MIN_SAVED_BILINEAR``, and its
    scratch, ``H*W*Kp`` floats a sample, is within
    ``VECTOR_SCRATCH_PER_SAVED`` floats per request saved."""
    if K < 2:
        return False
    Kp = vector_channels(K)
    saved = 4 * S * n * (K - (1 if K == 2 else Kp // 4))
    return (saved >= VECTOR_MIN_SAVED_BILINEAR
            and S * H * W * Kp <= VECTOR_SCRATCH_PER_SAVED * saved)


def vector_chunk(K: int, H: int, W: int) -> int:
    """Samples a launch of the vector route: as many as keep the scratch
    within ``VECTOR_CHUNK_BYTES``, at least one, at most
    ``BATCH_MAX_SAMPLES``."""
    per = H * W * vector_channels(K) * 4
    return max(1, min(BATCH_MAX_SAMPLES, VECTOR_CHUNK_BYTES // max(per, 1)))


def _bilinear_allowed(K: int, H: int, W: int) -> set:
    """Routes that can compute a (K, H, W) splat: the private kernel where
    the image fits 227 KB, the vector kernel for two channels or more, the
    direct kernel always."""
    routes = {"direct"}
    if K * H * W * 4 <= SHARED_MAX_BYTES:
        routes.add("private")
    if K >= 2:
        routes.add("vector")
    return routes


def bilinear_route(K: int, H: int, W: int, n: int) -> str:
    """Route of a (K, H, W) splat of n events: 'private' where the image
    fits 227 KB and n is at least 98304; 'vector' for K >= 2 past 227 KB
    where it pays (``vector_pays``); else 'direct'."""
    allowed = _bilinear_allowed(K, H, W)
    if "private" in allowed:
        return "private" if n >= PRIVATE_MIN_EVENTS else "direct"
    return "vector" if vector_pays(K, H, W, n) else "direct"


def bilinear_scatter(x, y, w, H: int, W: int, route=None):
    """(K, H, W) 4-tap bilinear splat of the K rows of ``w`` (f32 (K, N))
    at the shared f32 coordinates ``x``, ``y`` (N,); out-of-image taps are
    dropped.

    Routes, by shape alone (``bilinear_route``). 'private', where
    ``K*H*W*4`` bytes fit 227 KB of shared memory (181x241 at K=1 does, at
    K=4 it does not) and N >= 98304: one block of 1024 threads per 1024
    events, at most 132, each with a private image in shared memory whose
    non-zero pixels it adds to the zeroed output (a bulk reduction of whole
    images measured slower). 'vector', for K >= 2 past 227 KB (the
    timestamp image): each tap's K values go as one ``float2``/``float4``
    reduction into a zeroed channels-innermost scratch, which a second
    kernel unpacks into an uninitialised output. 'direct' for everything
    else: one thread per event, global atomics into the zeroed output.
    'single' (one block, image stored once into an uninitialised output) is
    slower than 'direct' wherever it was measured and is never chosen;
    ``route`` forces one of the routes the shape allows.
    """
    dev = _check("bilinear_scatter", (x, y, w), (_F32, _F32, _F32))
    if w.dim() != 2 or w.shape[1] != x.shape[0] or y.shape != x.shape:
        raise ConfigurationError(
            f"bilinear_scatter: w must be (K, {x.shape[0]}), got "
            f"{tuple(w.shape)}")
    K, n = w.shape
    allowed = _bilinear_allowed(K, H, W)
    if "private" in allowed:
        allowed.add("single")
    route = _pick("bilinear_scatter", route, bilinear_route(K, H, W, n),
                  allowed)
    if dev.type == "cpu":
        return bilinear_scatter_plain(x, y, w, H, W)
    if n == 0 or K == 0:
        return torch.zeros((K, H, W), dtype=_F32, device=dev)
    ptrs = (x.data_ptr(), y.data_ptr(), w.data_ptr())
    lib = build.library()
    if route == "direct":
        out = torch.zeros((K, H, W), dtype=_F32, device=dev)
        rc = lib.bilinear_scatter(*ptrs, n, K, H, W, out.data_ptr(),
                                  _stream())
    elif route == "vector":
        Kp = vector_channels(K)
        scratch = _vector_scratch(1, H, W, Kp, dev)
        out = torch.empty((K, H, W), dtype=_F32, device=dev)
        rc = lib.bilinear_scatter_vector(*ptrs, n, K, H, W, Kp,
                                         scratch.data_ptr(), out.data_ptr(),
                                         _stream())
    else:
        blocks = 1 if route == "single" else max(2, min(
            PRIVATE_MAX_BLOCKS, -(-n // PRIVATE_EVENTS_PER_BLOCK)))
        alloc = torch.empty if blocks == 1 else torch.zeros
        out = alloc((K, H, W), dtype=_F32, device=dev)
        rc = lib.bilinear_scatter_private(*ptrs, n, K, H, W, out.data_ptr(),
                                          blocks, _stream())
    build.check(rc, f"bilinear_scatter:{route}")
    _launches[f"bilinear_scatter:{route}"] += 1
    return out


def _vector_scratch(S: int, H: int, W: int, Kp: int, dev):
    """A zeroed channels-innermost scratch (S, H*W, Kp), 16-byte aligned
    for the vector reductions."""
    scratch = torch.zeros((S, H * W, Kp), dtype=_F32, device=dev)
    if scratch.data_ptr() % 16:
        raise ConfigurationError(
            "bilinear_scatter: scratch not aligned for vector reductions")
    return scratch


def _bilinear_vjp(g, dx, dy, taps, w):
    """Gather VJP of a bilinear splat (``_bilinear_core_bwd``,
    pallas_scatter.py:749): ``g`` is the output's cotangent flattened to
    (..., K, pixels), ``taps`` as ``_bilinear_taps`` returns them for
    (..., N) coordinates, ``w`` (..., K, N) or broadcast to it; the leading
    axes are the batched splat's samples. Cotangents of x, y and w."""
    def gather(ok, pix):
        idx = pix.unsqueeze(-2).expand(*g.shape[:-1], pix.shape[-1])
        return torch.where(ok.unsqueeze(-2), torch.gather(g, -1, idx), 0.0)

    tap = {(oy, ox): gather(ok, pix) for oy, ox, ok, pix in taps}
    g00, g01 = tap[(0, 0)], tap[(0, 1)]
    g10, g11 = tap[(1, 0)], tap[(1, 1)]
    dx = dx.unsqueeze(-2)
    dy = dy.unsqueeze(-2)
    g_w = (((1 - dx) * (1 - dy)) * g00 + (dx * (1 - dy)) * g01
           + ((1 - dx) * dy) * g10 + (dx * dy) * g11)
    g_x = torch.sum(w * ((1 - dy) * (g01 - g00) + dy * (g11 - g10)), dim=-2)
    g_y = torch.sum(w * ((1 - dx) * (g10 - g00) + dx * (g11 - g01)), dim=-2)
    return g_x, g_y, g_w


class _BilinearCore(torch.autograd.Function):
    """Bilinear splat with the gather VJP of ``_bilinear_core_bwd``
    (pallas_scatter.py:749): differentiable in x, y and w."""

    @staticmethod
    def forward(ctx, x, y, w, H, W):
        ctx.save_for_backward(x, y, w)
        ctx.dims = (H, W)
        return bilinear_scatter(x, y, w, H, W)

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        H, W = ctx.dims
        dx, dy, taps = _bilinear_taps(x, y, H, W)
        return (*_bilinear_vjp(g.reshape(g.shape[0], H * W), dx, dy, taps, w),
                None, None)


# ---------------------------------------------------------------------------
# Batched bilinear splat (replaces _bilinear_kernel under jax.vmap: Pallas
# adds a grid axis for the batch, pallas_scatter.py:576 / call :732)
# ---------------------------------------------------------------------------

# Samples that one batched launch takes: the grid's y extent, one sample a
# row. How many samples a caller materialises at once (their coordinates
# and images) is the caller's choice: ``events_cmax.batch_chunk``.
BATCH_MAX_SAMPLES = 65535


def bilinear_batched_route(K: int, H: int, W: int, n: int,
                           S: int = 1) -> str:
    """Route of a batched (S, K, H, W) splat of n events a sample:
    'private' where one sample's ``K*H*W*4`` bytes fit 227 KB of shared
    memory (181x241 at K = 1); past that 'vector' for K >= 2 where it pays
    (zhu's K = 4 stack), else 'direct'."""
    if "private" in _bilinear_allowed(K, H, W):
        return "private"
    return "vector" if vector_pays(K, H, W, n, S) else "direct"


def batched_chunk(route: str, K: int, H: int, W: int) -> int:
    """Samples that one launch of a batched route takes: the vector
    route's chunk (``vector_chunk``), else the grid's y extent."""
    return vector_chunk(K, H, W) if route == "vector" else BATCH_MAX_SAMPLES


def bilinear_scatter_batched_plain(x, y, w, H: int, W: int):
    """Plain version of ``bilinear_scatter_batched``: each tap of every
    sample's events summed with one ``index_add_`` over ids offset by the
    sample's and the channel's image, ``(w * wx) * wy`` as the kernel forms
    it; each image receives its terms in ``bilinear_scatter_plain``'s
    order. It computes in ``w``'s type (float64 inputs give a reference
    for the kernel's own rounding)."""
    S, n = x.shape
    K = w.shape[-2]
    dx, dy, taps = _bilinear_taps(x, y, H, W)
    wx = (1.0 - dx, dx)
    wy = (1.0 - dy, dy)
    base = torch.arange(S * K, device=x.device).view(S, K, 1) * (H * W)
    out = torch.zeros(S * K * H * W, dtype=w.dtype, device=x.device)
    for oy, ox, ok, pix in taps:
        val = (w * wx[ox][:, None, :]) * wy[oy][:, None, :]
        ids = base + pix[:, None, :]
        out.index_add_(0, ids.reshape(-1),
                       torch.where(ok[:, None, :], val, 0.0).reshape(-1))
    return out.view(S, K, H, W)


def bilinear_scatter_batched(x, y, w, H: int, W: int, route=None):
    """(S, K, H, W) bilinear splats of S samples: plane ``s`` is
    ``bilinear_scatter(x[s], y[s], w or w[s], H, W)``.

    ``x``, ``y`` f32 (S, N), one warped copy of the events per sample;
    ``w`` f32 (K, N), shared by every sample, or (S, K, N); all contiguous.
    Out-of-image, NaN and huge taps are dropped (bounds tested in float).
    CUDA tensors launch a kernel once per ``BATCH_MAX_SAMPLES`` samples
    (the grid's y extent), with the sample as the grid's y axis; CPU
    tensors run ``bilinear_scatter_batched_plain``.

    Routes, by shape alone (``bilinear_batched_route``). 'private' where
    one sample's image fits 227 KB of shared memory: G blocks of 1024
    threads per sample, each with a private image (``private_blocks``: for
    few samples what the card's 132 SMs leave per sample, at most one per
    1024 events; for more, up to 3 in waves where one a sample would leave
    SMs idle); with G = 1 each block stores its image into an
    uninitialised output, else the blocks add their non-zero pixels to a
    zeroed one. Past 227 KB: 'vector' for K >= 2 (zhu's K = 4 stack;
    launched in chunks of ``vector_chunk`` samples, the measured best),
    'direct' otherwise: one thread per slot, global atomics into the
    zeroed output. ``route`` forces one of the routes the shape allows.
    """
    dev = _check("bilinear_scatter_batched", (x, y, w), (_F32, _F32, _F32))
    if (x.dim() != 2 or y.shape != x.shape or w.dim() not in (2, 3)
            or w.shape[-1] != x.shape[1]
            or (w.dim() == 3 and w.shape[0] != x.shape[0])):
        raise ConfigurationError(
            f"bilinear_scatter_batched: x, y must be (S, N) and w (K, N) or "
            f"(S, K, N), got {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(w.shape)}")
    S, n = x.shape
    K = w.shape[-2]
    route = _pick("bilinear_scatter_batched", route,
                  bilinear_batched_route(K, H, W, n, S),
                  _bilinear_allowed(K, H, W))
    if dev.type == "cpu":
        return bilinear_scatter_batched_plain(x, y, w, H, W)
    if S == 0 or n == 0 or K == 0:
        return torch.zeros((S, K, H, W), dtype=_F32, device=dev)
    chunk = batched_chunk(route, K, H, W)
    w_stride = K * n if w.dim() == 3 else 0
    blocks = private_blocks(min(S, chunk), n)
    stores = route == "vector" or (route == "private" and blocks == 1)
    out = (torch.empty if stores else torch.zeros)((S, K, H, W), dtype=_F32,
                                                   device=dev)
    if route == "vector":
        Kp = vector_channels(K)
        scratch = _vector_scratch(min(S, chunk), H, W, Kp, dev)
    lib = build.library()
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        ptrs = (x[s0:s1].data_ptr(), y[s0:s1].data_ptr(),
                (w[s0:s1] if w_stride else w).data_ptr(), s1 - s0, n,
                w_stride, K, H, W)
        o = out[s0:s1].data_ptr()
        if route == "private":
            rc = lib.bilinear_scatter_batched_private(*ptrs, o, blocks,
                                                      _stream())
        elif route == "vector":
            if s0:
                scratch.zero_()
            rc = lib.bilinear_scatter_batched_vector(
                *ptrs, Kp, scratch.data_ptr(), o, _stream())
        else:
            rc = lib.bilinear_scatter_batched(*ptrs, o, _stream())
        build.check(rc, f"bilinear_scatter_batched:{route}")
        _launches[f"bilinear_scatter_batched:{route}"] += 1
    return out


class _BilinearBatchedCore(torch.autograd.Function):
    """Batched splat with the gather VJP of ``_bilinear_core_bwd``
    (pallas_scatter.py:749) extended by the sample axis: differentiable in
    x, y and w (shared weights get the sum over samples)."""

    @staticmethod
    def forward(ctx, x, y, w, H, W):
        ctx.save_for_backward(x, y, w)
        ctx.dims = (H, W)
        return bilinear_scatter_batched(x, y, w, H, W)

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        H, W = ctx.dims
        dx, dy, taps = _bilinear_taps(x, y, H, W)
        g_x, g_y, g_w = _bilinear_vjp(g.reshape(*g.shape[:2], H * W), dx, dy,
                                      taps, w)
        return g_x, g_y, g_w.sum(0) if w.dim() == 2 else g_w, None, None


def bilinear_matmul_batched(x, y, w, shape: Tuple[int, int], mask=None,
                            precision: str = "hilo"):
    """(S, K, H, W) bilinear splats of S parameter samples through the
    batched CUDA kernel: ``bilinear_matmul`` under ``jax.vmap`` over the
    warped coordinates.

    ``x``, ``y`` (S, N); ``w`` (K, N), shared by the samples, or (S, K, N);
    ``mask`` (N,) or (S, N) multiplies the weights. Differentiable in ``x``,
    ``y`` and ``w``.
    """
    _check_precision(precision)
    H, W = shape
    x = x.to(_F32).contiguous()
    y = y.to(_F32).contiguous()
    w = w.to(_F32)
    if mask is not None:
        w = w * torch.as_tensor(mask, device=w.device).to(_F32).unsqueeze(-2)
    return _BilinearBatchedCore.apply(x, y, w.contiguous(), H, W)


# ---------------------------------------------------------------------------
# Bilinear splat into per-run patches (the batched patch loss of the ROI
# solvers; in the JAX package each patch is one ``A @ V`` one-hot product,
# events_cmax.py:506-662, and a whole image is ``_bilinear_kernel``)
# ---------------------------------------------------------------------------

def _patch_taps(x, y, P: int, C: int, PH: int, PW: int):
    """``_bilinear_taps`` in patch-local coordinates, with the pixel ids
    moved to each slot's own patch of the flat (P*PH*PW,) output."""
    dx, dy, taps = _bilinear_taps(x, y, PH, PW)
    off = torch.arange(P, device=x.device).repeat_interleave(C) * (PH * PW)
    return dx, dy, [(oy, ox, ok, pix + off) for oy, ox, ok, pix in taps]


def bilinear_patches_scatter_plain(x, y, w, P: int, C: int, PH: int,
                                   PW: int):
    """Plain version of ``bilinear_patches_scatter``: the four taps of every
    slot, summed into the slot's own patch with ``index_add_``."""
    dx, dy, taps = _patch_taps(x, y, P, C, PH, PW)
    wx = (1.0 - dx, dx)
    wy = (1.0 - dy, dy)
    out = torch.zeros((w.shape[0], P * PH * PW), dtype=_F32, device=w.device)
    for oy, ox, ok, pix in taps:
        val = (w * wx[ox][None, :]) * wy[oy][None, :]
        out.index_add_(1, pix, torch.where(ok[None, :], val, 0.0))
    return out.view(-1, P, PH, PW)


# The patch count from which the patch kernel beats the direct one, from
# scripts/tune_scatter_routes.py on an H100 ((64, 128) patches of 2048
# slots: the direct kernel wins at 540 patches, the patch kernel at 1080,
# for K=1 and K=4 alike).
PATCH_MIN_PATCHES = 768


def bilinear_patches_route(P: int, PH: int, PW: int) -> str:
    """'patch' for at least 768 patches whose (PH, PW) plane fits a block's
    shared memory (227 KB), else 'direct'."""
    fits = PH * PW * 4 <= SHARED_MAX_BYTES
    return "patch" if fits and P >= PATCH_MIN_PATCHES else "direct"


def _patches_forward(x, y, w, P: int, C: int, PH: int, PW: int, route=None):
    dev = _check("bilinear_patches_scatter", (x, y, w), (_F32, _F32, _F32))
    if (x.dim() != 1 or x.shape[0] != P * C or y.shape != x.shape
            or w.dim() != 2 or w.shape[1] != P * C):
        raise ConfigurationError(
            f"bilinear_patches_scatter: x, y must be ({P * C},) and w "
            f"(K, {P * C}), got {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(w.shape)}")
    if dev.type == "cpu":
        return bilinear_patches_scatter_plain(x, y, w, P, C, PH, PW)
    K = w.shape[0]
    if P * C == 0 or K == 0:
        return torch.zeros((K, P, PH, PW), dtype=_F32, device=dev)
    fits = PH * PW * 4 <= SHARED_MAX_BYTES
    route = _pick("bilinear_patches_scatter", route,
                  bilinear_patches_route(P, PH, PW),
                  {"patch", "direct"} if fits else {"direct"})
    ptrs = (x.data_ptr(), y.data_ptr(), w.data_ptr())
    if route == "patch":
        out = torch.empty((K, P, PH, PW), dtype=_F32, device=dev)
        rc = build.library().bilinear_patches_scatter(
            *ptrs, P, C, K, PH, PW, out.data_ptr(), _stream())
        name = "bilinear_patches_scatter"
    else:
        out = torch.zeros((K, P, PH, PW), dtype=_F32, device=dev)
        rc = build.library().bilinear_patches_scatter_direct(
            *ptrs, P, C, K, PH, PW, out.data_ptr(), _stream())
        name = "bilinear_patches_scatter:direct"
    build.check(rc, name)
    _launches[name] += 1
    return out


class _BilinearPatchesCore(torch.autograd.Function):
    """Patch splat with the gather VJP of ``_bilinear_core_bwd``
    (pallas_scatter.py:749) on the (K, P, PH, PW) layout."""

    @staticmethod
    def forward(ctx, x, y, w, P, C, PH, PW, route):
        ctx.save_for_backward(x, y, w)
        ctx.dims = (P, C, PH, PW)
        return _patches_forward(x, y, w, P, C, PH, PW, route)

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        dx, dy, taps = _patch_taps(x, y, *ctx.dims)
        return (*_bilinear_vjp(g.reshape(g.shape[0], -1), dx, dy, taps, w),
                None, None, None, None, None)


def bilinear_patches_scatter(x, y, w, P: int, C: int, PH: int, PW: int,
                             route=None):
    """(K, P, PH, PW) bilinear splat of P runs of C slots, run ``q`` (slots
    ``q*C .. (q+1)*C - 1``) into patch ``q`` only.

    ``x``, ``y`` f32 (P*C,) *patch-local* coordinates, ``w`` f32 (K, P*C),
    all contiguous. The 4-tap rule is ``bilinear_scatter``'s; taps outside
    ``[0, PH) x [0, PW)`` are dropped (bounds tested in float), zero weights
    skip. With ``P = 1``, ``C = N``, ``(PH, PW) = (H, W)`` it is
    ``bilinear_scatter``. Differentiable in ``x``, ``y`` and ``w`` (gather
    backward, plain torch). CUDA tensors launch a kernel, CPU tensors run
    ``bilinear_patches_scatter_plain``.

    Routes, by shape alone (``bilinear_patches_route``). 'patch', for at
    least 768 patches whose (PH, PW) plane fits 227 KB of shared memory:
    one block of 256 threads per (channel, patch) holds its plane there (32
    KB for (64, 128)) and stores it once into an uninitialised output.
    'direct',
    for fewer patches (whose output stays in the L2, where float adds are
    native) and for larger planes: one thread per slot, global atomics into
    a zeroed output. ``route`` forces one of the routes the shape allows.
    """
    return _BilinearPatchesCore.apply(x, y, w, P, C, PH, PW, route)


# ---------------------------------------------------------------------------
# The variance patch loss, value and gradient (csrc/patch_loss_kernels.cu)
# ---------------------------------------------------------------------------

def patch_variance_shared_bytes(PH: int, PW: int, radius: int) -> int:
    """Shared memory of one block of ``patch_variance_vg``: two (PH, PW)
    f32 planes, the blur's 2r + 1 taps padded to a multiple of 4, 64 floats
    for its reductions and 4 ints (the kernel's ``shared_bytes``)."""
    return 4 * (2 * PH * PW + -(-(2 * radius + 1) // 4) * 4 + 64 + 4)


def patch_variance_fits(PH: int, PW: int, radius: int) -> bool:
    """Whether ``patch_variance_vg``'s block fits 227 KB of shared memory
    (two (64, 128) planes take 64 KB; (PH, PW) up to ~29,000 pixels fit)."""
    return patch_variance_shared_bytes(PH, PW, radius) <= SHARED_MAX_BYTES


def patch_variance_vg_plain(x, y, t, p, mask, origin_yx, params, taps,
                            roi_size, patch, full_pixels, grad=True):
    """Plain version of ``patch_variance_vg``: the same steps in torch ops,
    the gradient written out (no autograd)."""
    (PH, PW), (rh, rw) = patch, roi_size
    R, C = x.shape
    FP = float(full_pixels)
    on = mask != 0
    t0 = torch.where(on.any(-1), torch.where(on, t, -torch.inf).amax(-1),
                     0.0)
    dt = t - t0[:, None]
    # the patch's corner: the ROI's centre minus half the patch
    px = (x - dt * params[:, 0, None]) - (origin_yx[:, 1] + rw / 2.0
                                          - PW / 2.0)[:, None]
    py = (y - dt * params[:, 1, None]) - (origin_yx[:, 0] + rh / 2.0
                                          - PH / 2.0)[:, None]
    x0, y0 = torch.floor(px), torch.floor(py)
    inpatch = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
    w = ((p * mask) * inpatch.to(_F32)).reshape(1, -1)
    fx, fy = px.reshape(-1), py.reshape(-1)
    iwe = zero_pad_blur(bilinear_patches_scatter_plain(fx, fy, w, R, C, PH,
                                                       PW)[0], taps)
    S = iwe.sum((-2, -1))
    loss = -((iwe * iwe).sum((-2, -1)) / FP - (S / FP) ** 2)
    if not grad:
        return loss, None
    g_iwe = -2.0 * iwe / FP + (2.0 * S / FP ** 2)[:, None, None]
    back = zero_pad_blur(g_iwe, torch.flip(taps, (0,)))
    dx, dy, tap4 = _patch_taps(fx, fy, R, C, PH, PW)
    g_x, g_y, _ = _bilinear_vjp(back.reshape(1, -1), dx, dy, tap4, w)
    return loss, torch.stack([-(g_x.view(R, C) * dt).sum(-1),
                              -(g_y.view(R, C) * dt).sum(-1)], -1)


def patch_variance_vg(x, y, t, p, mask, origin_yx, params, taps, roi_size,
                      patch, full_pixels, grad=True):
    """One evaluation of the ROI patch loss of the variance objective under
    the linear-velocity warp (``events_cmax.make_patch_loss``'s value for
    (R, 2) params), and its gradient in ``params``: ``(loss (R,), grad (R,
    2))``, or ``(loss, None)`` with ``grad=False``.

    ``x, y, t, p, mask`` (R, C) f32 slots of R ROIs, ``origin_yx`` (R, 2)
    f32 ROI corners (y, x), ``params`` (R, 2) f32 velocities (vx, vy),
    ``taps`` the blur's 2r + 1 f32 taps, all contiguous on one device;
    ``roi_size`` (rh, rw), ``patch`` (PH, PW), ``full_pixels`` the full
    frame's pixel count FP. Per ROI: ``t0`` the latest masked-in stamp (0
    for an empty ROI); slots warped to ``t0`` in patch-local coordinates;
    weights ``p * mask`` splatted bilinearly where all four taps lie in the
    patch; the zero-padded blur by ``taps``; loss ``-(Q/FP - (S/FP)^2)``
    with Q and S the sums of the blurred patch's squares and pixels.

    CUDA tensors launch ``patch_variance_vg_kernel``, one block of 1024
    threads per ROI with both planes in shared memory
    (``patch_variance_fits``), and count one launch; CPU tensors run
    ``patch_variance_vg_plain``. Not differentiable itself: the caller's
    ``torch.autograd.Function`` applies the gradient it returns.
    """
    dev = _check("patch_variance_vg", (x, y, t, p, mask, origin_yx, params,
                                       taps), (_F32,) * 8)
    PH, PW = patch
    R = x.shape[0]
    if (x.dim() != 2 or any(a.shape != x.shape for a in (y, t, p, mask))
            or origin_yx.shape != (R, 2) or params.shape != (R, 2)
            or taps.dim() != 1 or taps.shape[0] % 2 != 1):
        raise ConfigurationError(
            f"patch_variance_vg: slots must be (R, C), origin and params "
            f"(R, 2), taps odd (2r + 1,), got {tuple(x.shape)}, "
            f"{tuple(origin_yx.shape)}, {tuple(params.shape)}, "
            f"{tuple(taps.shape)}")
    radius = taps.shape[0] // 2
    if not patch_variance_fits(PH, PW, radius):
        raise ConfigurationError(
            f"patch_variance_vg: two ({PH}, {PW}) planes and {2 * radius + 1}"
            f" taps exceed {SHARED_MAX_BYTES} B of shared memory")
    if dev.type == "cpu":
        return patch_variance_vg_plain(x, y, t, p, mask, origin_yx, params,
                                       taps, roi_size, patch, full_pixels,
                                       grad)
    loss = torch.empty((R,), dtype=_F32, device=dev)
    g = torch.empty((R, 2), dtype=_F32, device=dev) if grad else None
    rc = build.library("patch_loss_kernels").patch_variance_vg(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), p.data_ptr(),
        mask.data_ptr(), origin_yx.data_ptr(), params.data_ptr(),
        taps.data_ptr(), R, x.shape[1], radius, PH, PW, roi_size[0] / 2.0,
        roi_size[1] / 2.0, float(full_pixels), int(grad), loss.data_ptr(),
        g.data_ptr() if grad else None, _stream())
    build.check(rc, "patch_variance_vg")
    _launches["patch_variance_vg"] += 1
    return loss, g


def bilinear_matmul(x, y, w, shape: Tuple[int, int], mask=None,
                    precision: str = "hilo"):
    """(H, W) or (K, H, W) 4-tap bilinear scatter-add (``bilinear_matmul``,
    pallas_scatter.py:649) through the CUDA bilinear kernel.

    Float coordinates, K weight channels sharing them (IWE: K=1; timestamp
    image: K=4; Jacobian stacks: K=D). Out-of-image taps are dropped and
    ``mask`` multiplies the weights. Differentiable in ``x``, ``y``, ``w``.
    """
    _check_precision(precision)
    H, W = shape
    x = x.to(_F32).contiguous()
    y = y.to(_F32).contiguous()
    w = w.to(_F32)
    single = w.dim() == 1
    w2 = w[None, :] if single else w
    if mask is not None:
        w2 = w2 * torch.as_tensor(mask, device=w2.device).to(_F32)[None, :]
    out = _BilinearCore.apply(x, y, w2.contiguous(), H, W)
    return out[0] if single else out


def reset_launch_counts() -> None:
    """Set every route's launch count to 0."""
    for route in ROUTES:
        _launches[route] = 0


def launch_counts() -> dict:
    """Launches of every kernel route since the last reset."""
    return dict(_launches)


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (route: launches, negative to take away) to the launch
    counts: a CUDA graph's replay launches its kernels without running the
    wrappers that count them."""
    for route, n in counts.items():
        _launches[route] += n


# The wrapper that launches each route.
KERNEL_WRAPPERS = {
    "voxel_scatter:vector": voxel_scatter,
    "voxel_scatter:direct": voxel_scatter,
    "voxel_scatter_batched:vector": voxel_scatter_batched,
    "voxel_scatter_batched:direct": voxel_scatter_batched,
    "voxel_scatter_batched:private": voxel_scatter_batched,
    "voxel_tiles_scatter:private": voxel_tiles_scatter,
    "voxel_tiles_scatter:direct": voxel_tiles_scatter,
    "flat_scatter:vector": flat_scatter,
    "flat_scatter:direct": flat_scatter,
    "bilinear_scatter:direct": bilinear_scatter,
    "bilinear_scatter:private": bilinear_scatter,
    "bilinear_scatter:single": bilinear_scatter,
    "bilinear_scatter:vector": bilinear_scatter,
    "bilinear_scatter_batched:private": bilinear_scatter_batched,
    "bilinear_scatter_batched:direct": bilinear_scatter_batched,
    "bilinear_scatter_batched:vector": bilinear_scatter_batched,
    "bilinear_patches_scatter": bilinear_patches_scatter,
    "bilinear_patches_scatter:direct": bilinear_patches_scatter,
    "patch_variance_vg": patch_variance_vg,
}
