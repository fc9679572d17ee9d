"""Scatter-add accumulation primitives (port of ``event_utils_tpu.ops.scatter``).

Every dense representation bottoms out in one of three primitives: the
4-tap bilinear scatter-add, the Jacobian-weighted bilinear scatter, and the
integer scatter-add. Semantics are the JAX package's:

* invalid events scatter *nowhere*: negative and out-of-range ids are
  dropped, never wrapped; float coordinates truncate toward zero in
  ``scatter_add_2d`` and floor in the bilinear paths;
* differentiable in ``x``, ``y`` and ``w`` through the bilinear weights.

``impl`` selects the route, with the JAX strings:

- ``'xla'`` (default): ``index_add`` — exact f32, atomics on the card;
- ``'sort'``: sorted segment-sum (argsort, cumsum, searchsorted) — the
  deterministic route: bitwise reproducible from run to run on one device;
- ``'pallas'`` and ``'matmul'``/``'matmul_hilo'``/``'matmul_bf16'``: the
  hand-written CUDA kernels of ``ops.cuda_scatter`` for CUDA tensors, their
  plain versions for CPU tensors. They compute in f32.

Divergence from the JAX package: its XLA TPU scatter accumulates in a fixed
order, so every route there is bitwise reproducible; on the card only
'sort' is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import as_f32, as_tensor, pick_device
from ..errors import ConfigurationError
from . import cuda_scatter

_IMPLEMENTATIONS = ("xla", "sort", "pallas")
# Kernel routes accepted by the 2-D/bilinear entry points:
#   'matmul' / 'matmul_hilo' / 'matmul_bf16' -> the CUDA kernels (f32)
_MATMUL_IMPLS = ("matmul", "matmul_hilo", "matmul_bf16")
_DEFAULT_IMPL = "xla"


def _matmul_precision(impl: str) -> str:
    return "bf16" if impl == "matmul_bf16" else "hilo"


def set_default_impl(impl: str) -> None:
    """Select the default scatter implementation ('xla', 'sort' or 'pallas')."""
    global _DEFAULT_IMPL
    if impl not in _IMPLEMENTATIONS:
        raise ConfigurationError(
            f"impl must be one of {_IMPLEMENTATIONS}, got {impl!r}")
    _DEFAULT_IMPL = impl


def get_default_impl() -> str:
    return _DEFAULT_IMPL


def _int_coords(a: torch.Tensor) -> torch.Tensor:
    """int64 coordinates; floats truncate toward zero (torch ``.long()``)."""
    if a.is_floating_point():
        a = torch.trunc(a)
    return a.long()


# ---------------------------------------------------------------------------
# Flat scatter core
# ---------------------------------------------------------------------------

def scatter_add_flat(idx, w, num_buckets: int, *, impl: Optional[str] = None,
                     device=None) -> torch.Tensor:
    """Sum ``w`` into ``num_buckets`` buckets by integer id ``idx``.

    Out-of-range ids (negative or >= num_buckets) are dropped.
    """
    impl = impl or _DEFAULT_IMPL
    if impl not in _IMPLEMENTATIONS:
        raise ConfigurationError(
            f"scatter_add_flat impl must be one of {_IMPLEMENTATIONS}, got "
            f"{impl!r} (the matmul fast paths exist only for the 2-D/bilinear "
            "entry points — a flat scatter has no factorized form)")
    dev = pick_device(idx, w, device=device)
    idx = as_tensor(idx, dev).long()
    w = as_tensor(w, dev)
    ok = (idx >= 0) & (idx < num_buckets)
    if impl == "sort":
        return _scatter_add_flat_sorted(torch.where(ok, idx, num_buckets), w,
                                        num_buckets)
    if impl == "pallas":
        return cuda_scatter.scatter_add_flat_cuda(idx, w, num_buckets)
    out = torch.zeros((num_buckets,), dtype=w.dtype, device=dev)
    return out.index_add(0, torch.where(ok, idx, 0),
                         torch.where(ok, w, torch.zeros_like(w)))


def _scatter_add_flat_sorted(idx, w, num_buckets: int) -> torch.Tensor:
    """Sort-based segment-sum scatter (deterministic, collision-free).

    Stable sort of (idx, w) by idx -> cumulative sum -> per-bucket total
    from the bucket boundaries (searchsorted). Dropped ids were mapped to
    ``num_buckets`` and sort to the tail.
    """
    idx_s, order = torch.sort(idx, stable=True)
    csum = torch.cumsum(w[order].to(torch.float32), 0)
    bounds = torch.searchsorted(
        idx_s, torch.arange(num_buckets + 1, dtype=idx_s.dtype,
                            device=idx_s.device))
    csum0 = torch.cat([csum.new_zeros(1), csum])
    totals = csum0[bounds[1:]] - csum0[bounds[:-1]]
    return totals.to(w.dtype)


# ---------------------------------------------------------------------------
# 2-D integer scatter
# ---------------------------------------------------------------------------

def scatter_add_2d(ix, iy, w, shape: Tuple[int, int], *, mask=None,
                   impl: Optional[str] = None, device=None) -> torch.Tensor:
    """Integer scatter-add into an ``(H, W)`` image, out-of-bounds events
    dropped. Float ``ix``/``iy`` truncate toward zero (torch ``.long()``).
    """
    H, W = shape
    dev = pick_device(ix, iy, w, mask, device=device)
    ix = _int_coords(as_tensor(ix, dev))
    iy = _int_coords(as_tensor(iy, dev))
    w = as_tensor(w, dev)
    oob = (ix < 0) | (ix >= W) | (iy < 0) | (iy >= H)
    if mask is not None:
        oob = oob | (as_tensor(mask, dev) == 0)
    if (impl or _DEFAULT_IMPL) in _MATMUL_IMPLS:
        w = torch.where(oob, 0.0, w.to(torch.float32))
        return cuda_scatter.image_matmul(
            torch.where(oob, 0, ix), torch.where(oob, 0, iy), w, shape,
            precision=_matmul_precision(impl))
    flat = torch.where(oob, -1, iy * W + ix)
    return scatter_add_flat(flat, w, H * W, impl=impl).view(H, W)


# ---------------------------------------------------------------------------
# Bilinear scatter
# ---------------------------------------------------------------------------

def _bilinear_taps(x, y, w, shape: Tuple[int, int], mask):
    """The 4 (flat index, weight) tap pairs of bilinear interpolation.

    Taps outside ``shape`` get index -1 (dropped by the scatter). Weights:
      (x0,y0): w(1-dx)(1-dy)   (x0+1,y0): w dx (1-dy)
      (x0,y0+1): w(1-dx)dy     (x0+1,y0+1): w dx dy
    """
    H, W = shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).to(w.dtype)
    dy = (y - y0).to(w.dtype)
    if mask is not None:
        w = w * mask.to(w.dtype)
    wx = (1.0 - dx, dx)
    wy = (1.0 - dy, dy)
    idxs, ws = [], []
    for oy in (0, 1):
        for ox in (0, 1):
            xx = x0 + ox
            yy = y0 + oy
            valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            if mask is not None:
                valid = valid & (mask != 0)
            pix = (torch.where(valid, yy, 0.0).long() * W
                   + torch.where(valid, xx, 0.0).long())
            idxs.append(torch.where(valid, pix, -1))
            ws.append(w * wx[ox] * wy[oy])
    return idxs, ws


def bilinear_scatter(x, y, w, shape: Tuple[int, int], *, mask=None,
                     impl: Optional[str] = None, device=None) -> torch.Tensor:
    """4-tap bilinear scatter-add of weights ``w`` at float coords ``(x, y)``.

    Differentiable in ``x``, ``y`` and ``w``; out-of-image taps are dropped.
    ``impl='matmul'`` (and its aliases) runs the CUDA bilinear kernel.
    """
    impl = impl or _DEFAULT_IMPL
    dev = pick_device(x, y, w, mask, device=device)
    x = as_f32(x, dev)
    y = as_f32(y, dev)
    w = as_tensor(w, dev)
    if mask is not None:
        mask = as_tensor(mask, dev)
    if impl in _MATMUL_IMPLS:
        return cuda_scatter.bilinear_matmul(x, y, w, shape, mask=mask,
                                            precision=_matmul_precision(impl))
    H, W = shape
    idxs, ws = _bilinear_taps(x, y, w, shape, mask)
    img = scatter_add_flat(torch.cat(idxs), torch.cat(ws), H * W, impl=impl)
    return img.view(H, W)


def bilinear_scatter_derivative(x, y, jx, jy, w, shape: Tuple[int, int], *,
                                mask=None, impl: Optional[str] = None,
                                device=None) -> torch.Tensor:
    """Jacobian-weighted bilinear scatter producing the dIWE/dparams stack.

    For each motion-parameter dimension k::

        d_img[k] = Σ_n  w1[k,n] * dTap/dx + w2[k,n] * dTap/dy

    with ``w1 = jx*w``, ``w2 = jy*w`` and the signed bilinear-derivative tap
    weights. ``jx``, ``jy``: (D, N); ``w``: (N,). Returns (D, H, W).
    The kernel routes make one flat-kernel launch over a (D, 4N) block.
    """
    H, W = shape
    dev = pick_device(x, y, jx, jy, w, mask, device=device)
    x = as_f32(x, dev)
    y = as_f32(y, dev)
    w = as_tensor(w, dev)
    jx = as_tensor(jx, dev)
    jy = as_tensor(jy, dev)
    if mask is not None:
        mask = as_tensor(mask, dev)
    flat_idx, flat_w = derivative_taps(x, y, jx, jy, w, shape, mask)
    impl = impl or _DEFAULT_IMPL
    if impl in _MATMUL_IMPLS:
        out = cuda_scatter.scatter_add_flat_cuda(
            flat_idx, flat_w, H * W, precision=_matmul_precision(impl))
        return out.view(-1, H, W)
    return torch.stack([scatter_add_flat(flat_idx, wd, H * W, impl=impl)
                        .view(H, W) for wd in flat_w])


def derivative_taps(x, y, jx, jy, w, shape: Tuple[int, int], mask=None):
    """The flat ids (4N,) and signed weights (D, 4N) that
    ``bilinear_scatter_derivative`` scatters (ids of dropped taps are -1)."""
    H, W = shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).to(w.dtype)
    dy = (y - y0).to(w.dtype)

    w1 = jx * w[None, :]
    w2 = jy * w[None, :]
    if mask is not None:
        m = mask.to(w.dtype)[None, :]
        w1 = w1 * m
        w2 = w2 * m

    # Signed derivative weights of the four bilinear taps:
    #   tap (y0, x0):     w1*(-(1-dy)) + w2*(-(1-dx))
    #   tap (y0, x0+1):   w1*(1-dy)    + w2*(-dx)
    #   tap (y0+1, x0):   w1*(-dy)     + w2*(1-dx)
    #   tap (y0+1, x0+1): w1*dy        + w2*dx
    tap_wts = (
        (0, 0, -(1.0 - dy), -(1.0 - dx)),
        (0, 1, (1.0 - dy), -dx),
        (1, 0, -dy, (1.0 - dx)),
        (1, 1, dy, dx),
    )
    idxs, ws = [], []
    for oy, ox, a, b in tap_wts:
        xx = x0 + ox
        yy = y0 + oy
        valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        if mask is not None:
            valid = valid & (mask != 0)
        pix = (torch.where(valid, yy, 0.0).long() * W
               + torch.where(valid, xx, 0.0).long())
        idxs.append(torch.where(valid, pix, -1))
        ws.append(w1 * a[None, :] + w2 * b[None, :])  # (D, N)

    return torch.cat(idxs), torch.cat(ws, dim=1)


# ---------------------------------------------------------------------------
# Bilinear gather (the reverse op)
# ---------------------------------------------------------------------------

def bilinear_gather(x, y, img, *, mask=None, device=None) -> torch.Tensor:
    """Sample ``img`` at float coords with 4-tap bilinear interpolation.

    Out-of-image taps contribute 0; masked events return 0.
    """
    dev = pick_device(img, x, y, mask, device=device)
    img = as_tensor(img, dev)
    x = as_f32(x, dev)
    y = as_f32(y, dev)
    H, W = img.shape[-2], img.shape[-1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0

    def tap(oy, ox, wt):
        xx = x0 + ox
        yy = y0 + oy
        valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        ix = torch.where(valid, xx, 0.0).long()
        iy = torch.where(valid, yy, 0.0).long()
        v = img[..., iy, ix]
        return torch.where(valid, v, torch.zeros_like(v)) * wt

    out = (tap(0, 0, (1 - dx) * (1 - dy)) + tap(0, 1, dx * (1 - dy))
           + tap(1, 0, (1 - dx) * dy) + tap(1, 1, dx * dy))
    if mask is not None:
        out = out * as_tensor(mask, dev).to(out.dtype)
    return out
