"""Separable Gaussian blur with ``scipy.ndimage.gaussian_filter`` parity
(port of ``event_utils_tpu.ops.blur``).

- kernel radius = int(truncate * sigma + 0.5), truncate = 4.0
- kernel k[i] = exp(-0.5 * i^2 / sigma^2), normalized to sum 1
- 'reflect' boundary mode (d c b a | a b c d | d c b a), i.e. numpy's
  'symmetric' — not ``F.pad(mode='reflect')``, which skips the edge sample
- applied separably along *every* axis of the input, so a (2, H, W) dIWE
  stack is also blurred across its parameter axis, as scipy does; pass
  ``axes=(-2, -1)`` for spatial-only blurring.

Each axis is one ``conv1d`` over the explicitly padded last axis. The
convolution runs with TF32 off (``_device.no_tf32``): cuDNN would run an f32
convolution in TF32 by default, about three decimal digits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, no_tf32, resolve_device


def gaussian_kernel1d(sigma: float, truncate: float = 4.0,
                      radius: Optional[int] = None) -> np.ndarray:
    """The scipy.ndimage _gaussian_kernel1d (order 0), as a numpy constant."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    k /= k.sum()
    return k


def _reflect_pad_last(x: torch.Tensor, r: int) -> torch.Tensor:
    """scipy 'reflect' padding (d c b a | a b c d | d c b a) on the last axis."""
    if r == 0:
        return x
    n = x.shape[-1]
    if r <= n:
        left = torch.flip(x[..., :r], dims=(-1,))
        right = torch.flip(x[..., -r:], dims=(-1,))
        return torch.cat([left, x, right], dim=-1)
    # radius larger than the axis (the dIWE parameter axis with sigma >= 1)
    idx = np.arange(-r, n + r)
    period = 2 * n
    idx = np.mod(idx, period)
    idx = np.where(idx >= n, period - 1 - idx, idx)
    return x[..., torch.as_tensor(idx, device=x.device)]


def _blur_last_axis(x: torch.Tensor, sigma: float,
                    truncate: float) -> torch.Tensor:
    r = int(truncate * float(sigma) + 0.5)
    if r == 0 or sigma <= 0:
        return x
    k = torch.as_tensor(gaussian_kernel1d(sigma, truncate), dtype=x.dtype,
                        device=x.device)
    xp = _reflect_pad_last(x, r)
    shape = xp.shape
    out = F.conv1d(xp.reshape(-1, 1, shape[-1]),
                   torch.flip(k, dims=(0,)).view(1, 1, -1))
    return out.reshape(*shape[:-1], out.shape[-1])


def zero_pad_blur(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'same' blur with zero padding over the last two axes (the
    JAX patch loss's ``conv_general_dilated`` pair) by the taps ``k``, a
    float32 tensor on ``img``'s device: the columns first, then the rows."""
    r = k.shape[0] // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    with no_tf32():
        x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(r, 0))
        x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x.reshape(*lead, h, w)


def gaussian_filter(x: torch.Tensor, sigma: float, *, truncate: float = 4.0,
                    axes: Optional[Sequence[int]] = None,
                    device=None) -> torch.Tensor:
    """N-D separable Gaussian blur matching ``scipy.ndimage.gaussian_filter``.

    @param x Input tensor (any rank)
    @param sigma Scalar standard deviation (applied along each blurred axis)
    @param truncate Kernel radius in standard deviations (scipy default 4.0)
    @param axes Axes to blur; defaults to *all* axes (scipy behavior)
    @returns Blurred tensor, same shape/dtype
    """
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, resolve_device(device))
    if sigma is None or sigma <= 0:
        return x
    # Integer inputs: convolve in float and round back once at the end (the
    # JAX package's documented divergence from scipy's per-pass truncation).
    int_dtype = not (x.is_floating_point() or x.is_complex())
    orig_dtype = x.dtype
    if int_dtype:
        x = x.to(torch.float32)
    ndim = x.dim()
    if axes is None:
        axes = tuple(range(ndim))
    axes = tuple(a % ndim for a in axes)
    with no_tf32():
        for ax in axes:
            x = torch.movedim(x, ax, -1)
            x = _blur_last_axis(x, sigma, truncate)
            x = torch.movedim(x, -1, ax)
    if int_dtype:
        x = torch.round(x).to(orig_dtype)
    return x


def gaussian_blur_image(img: torch.Tensor, sigma: float, *,
                        truncate: float = 4.0) -> torch.Tensor:
    """Spatial-only blur of an (..., H, W) image stack."""
    return gaussian_filter(img, sigma, truncate=truncate, axes=(-2, -1))
