"""Hand-written CUDA accumulation kernels, their plain versions and drivers.

Counterpart of the JAX package's ``ops/pallas_scatter.py``. The TPU kernels
there recast scatter-add as one-hot matmuls on the MXU, because a TPU has no
fast scatter. An H100 has fast atomics in its L2, so the kernels in
``csrc/scatter_kernels.cu`` compute the same functions directly, one thread
per event:

================================  =========================================
kernel wrapper (this module)      TPU kernel it replaces (pallas_scatter.py)
================================  =========================================
``voxel_scatter``                 ``_voxel_kernel`` via ``voxel_matmul``
``flat_scatter``                  ``_image_kernel`` via ``image_matmul`` and
                                  ``scatter_add_flat_pallas``
``bilinear_scatter``              ``_bilinear_kernel`` via
                                  ``bilinear_matmul``
================================  =========================================

Each wrapper launches its kernel when its tensors lie on the card and adds
one to its ``launches`` count when it does, and only then. For tensors on
the CPU it runs its plain PyTorch version (``*_plain``, ``index_add_``
based) instead: that is what the CPU tests run, and nothing on the main
path calls the plain version when a card is present. There is no fallback:
on a CUDA tensor a wrapper launches or raises.

The drivers keep the JAX names and preprocessing (``voxel_matmul``,
``image_matmul``, ``bilinear_matmul``; ``scatter_add_flat_cuda`` stands for
``scatter_add_flat_pallas``) so that each has one counterpart to be held
against. ``precision`` is accepted with the JAX values ('hilo', 'bf16',
'int8') and every kernel computes in f32, which lies inside each of those
precision classes. The VMEM planning of the TPU drivers (``_fit_chunk``,
``SensorLimitError``, the oversized-sensor fallbacks) has no counterpart:
the card has no such limit.

Gradients: ``voxel_matmul`` and ``bilinear_matmul`` are
``torch.autograd.Function``s whose backward is the plain-torch gather of
``_voxel_core_bwd`` / ``_bilinear_core_bwd`` (plain jnp in the JAX package,
so plain torch here); the flat scatter's backward is a gather too.

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


def voxel_scatter(xs, ys, t_norm, ps, B: int, H: int, W: int):
    """(B, H, W) temporally-bilinear voxel grid of preprocessed events.

    ``xs``/``ys`` int32 in-image coordinates, ``t_norm`` f32 in [0, B-1],
    ``ps`` f32 weights (0 for dropped events) — what ``voxel_matmul``
    hands over. Launches the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors.
    """
    dev = _check("voxel_scatter", (xs, ys, t_norm, ps), (_I32, _I32, _F32, _F32))
    if dev.type == "cpu":
        return voxel_scatter_plain(xs, ys, t_norm, ps, B, H, W)
    out = torch.zeros((B, H, W), dtype=_F32, device=dev)
    n = xs.shape[0]
    if n == 0:
        return out
    rc = build.library().voxel_scatter(
        xs.data_ptr(), ys.data_ptr(), t_norm.data_ptr(), ps.data_ptr(), n,
        B, H, W, out.data_ptr(), _stream())
    build.check(rc, "voxel_scatter")
    voxel_scatter.launches += 1
    return out


voxel_scatter.launches = 0


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
        B, H, W = ctx.dims
        b0 = torch.floor(t_norm)
        fb = t_norm - b0
        ib0 = torch.where(torch.isfinite(b0), b0, -1.0).clamp(-1, B).long()
        yy = ys.long().clamp(0, H - 1)
        xx = xs.long().clamp(0, W - 1)

        def tap_cot(ib):
            ok = (ib >= 0) & (ib < B)
            return torch.where(ok, g[ib.clamp(0, B - 1), yy, xx], 0.0)

        g0 = tap_cot(ib0)
        g1 = tap_cot(ib0 + 1)
        g_ps = (1.0 - fb) * g0 + fb * g1
        g_t = ps * (g1 - g0)
        return None, None, g_t, g_ps, None, None, None


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
    in [0, B-1], f32 weights with dropped events at 0). Differentiable in
    ``ts`` and ``ps``."""
    H, W = sensor_size
    dev = xs.device
    xs = xs.to(_I32)
    ys = ys.to(_I32)
    ts = ts.to(_F32)
    ps = ps.to(_F32)
    in_img = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    ps = torch.where(in_img, ps, 0.0)
    if mask is not None:
        ps = ps * torch.as_tensor(mask, device=dev).to(_F32)
    xs = xs.clamp(0, W - 1).contiguous()
    ys = ys.clamp(0, H - 1).contiguous()

    if t0 is None or t1 is None:
        if mask is None:
            tt0, tt1 = ts[0], ts[-1]
        else:
            valid = torch.as_tensor(mask, device=dev) != 0
            big = 3.4e38
            tt0 = torch.where(valid, ts, big).min()
            tt1 = torch.where(valid, ts, -big).max()
        t0 = tt0 if t0 is None else t0
        t1 = tt1 if t1 is None else t1
    t0 = torch.as_tensor(t0, dtype=_F32, device=dev)
    t1 = torch.as_tensor(t1, dtype=_F32, device=dev)
    dt = t1 - t0
    t_norm = (ts - t0) / torch.where(dt == 0, 1.0, dt) * (B - 1)

    # Out-of-window events (only under t0/t1 overrides): fold the surviving
    # edge-bin tap into ps and pin t_norm to the edge, as the JAX driver
    # does (its kernel's per-chunk bin classification needs it; here it
    # keeps the two drivers' outputs and VJPs the same function).
    below = t_norm < 0.0
    above = t_norm > (B - 1.0)
    ps = torch.where(below, ps * torch.clamp(1.0 + t_norm, min=0.0), ps)
    ps = torch.where(above,
                     ps * torch.clamp(1.0 - (t_norm - (B - 1.0)), min=0.0), ps)
    t_norm = torch.where(below, 0.0, t_norm)
    t_norm = torch.where(above, float(B - 1), t_norm)
    return xs, ys, t_norm.contiguous(), ps.contiguous()


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


def flat_scatter(idx, w, num_buckets: int):
    """(D, num_buckets) scatter-add: row d sums ``w[d]`` by bucket ``idx``.

    ``idx`` int32 (N,), ids outside ``[0, num_buckets)`` dropped; ``w`` f32
    (D, N). One launch for all D rows.
    """
    dev = _check("flat_scatter", (idx, w), (_I32, _F32))
    if w.dim() != 2 or w.shape[1] != idx.shape[0]:
        raise ConfigurationError(
            f"flat_scatter: w must be (D, {idx.shape[0]}), got {tuple(w.shape)}")
    if dev.type == "cpu":
        return flat_scatter_plain(idx, w, num_buckets)
    D, n = w.shape
    out = torch.zeros((D, num_buckets), dtype=_F32, device=dev)
    if n == 0 or D == 0:
        return out
    rc = build.library().flat_scatter(
        idx.data_ptr(), w.data_ptr(), n, D, num_buckets, out.data_ptr(),
        _stream())
    build.check(rc, "flat_scatter")
    flat_scatter.launches += 1
    return out


flat_scatter.launches = 0


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


def bilinear_scatter(x, y, w, H: int, W: int):
    """(K, H, W) 4-tap bilinear splat of the K rows of ``w`` (f32 (K, N))
    at the shared f32 coordinates ``x``, ``y`` (N,); out-of-image taps are
    dropped."""
    dev = _check("bilinear_scatter", (x, y, w), (_F32, _F32, _F32))
    if w.dim() != 2 or w.shape[1] != x.shape[0] or y.shape != x.shape:
        raise ConfigurationError(
            f"bilinear_scatter: w must be (K, {x.shape[0]}), got "
            f"{tuple(w.shape)}")
    if dev.type == "cpu":
        return bilinear_scatter_plain(x, y, w, H, W)
    K, n = w.shape
    out = torch.zeros((K, H, W), dtype=_F32, device=dev)
    if n == 0 or K == 0:
        return out
    rc = build.library().bilinear_scatter(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), n, K, H, W, out.data_ptr(),
        _stream())
    build.check(rc, "bilinear_scatter")
    bilinear_scatter.launches += 1
    return out


bilinear_scatter.launches = 0


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
        gflat = g.reshape(g.shape[0], H * W)
        tap = {(oy, ox): torch.where(ok[None, :], gflat[:, pix], 0.0)
               for oy, ox, ok, pix in taps}
        g00, g01 = tap[(0, 0)], tap[(0, 1)]
        g10, g11 = tap[(1, 0)], tap[(1, 1)]
        g_w = (((1 - dx) * (1 - dy))[None] * g00 + (dx * (1 - dy))[None] * g01
               + ((1 - dx) * dy)[None] * g10 + (dx * dy)[None] * g11)
        g_x = torch.sum(w * ((1 - dy)[None] * (g01 - g00)
                             + dy[None] * (g11 - g10)), dim=0)
        g_y = torch.sum(w * ((1 - dx)[None] * (g10 - g00)
                             + dx[None] * (g11 - g01)), dim=0)
        return g_x, g_y, g_w, None, None


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
    """Set every kernel's launch count to 0."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


KERNEL_WRAPPERS = {
    "voxel_scatter": voxel_scatter,
    "flat_scatter": flat_scatter,
    "bilinear_scatter": bilinear_scatter,
}
