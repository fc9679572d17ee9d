"""Image-quality metrics (PSNR / SSIM / AEE), pure numpy+scipy.

Port of ``event_utils_tpu.utils.metrics`` (a copy: the module is numpy
already). Used by ``cli.reconstruct --eval_gt`` to score E2VID output
against ground-truth frames and by ``cli.infer_flow --eval_gt`` for the
flow error. NHW or HW arrays in [0, 1].

Host-side on purpose: these score small eval images, where a device round
trip buys nothing, and numpy is exactly reproducible. Tensors are accepted
and copied to the host.
"""

from __future__ import annotations

import numpy as np

from .._device import to_numpy

Array = np.ndarray


def _f32(a) -> np.ndarray:
    return np.asarray(to_numpy(a), np.float32)


def psnr(pred, target, max_val: float = 1.0) -> Array:
    """Peak signal-to-noise ratio in dB over the trailing (H, W) axes."""
    pred, target = _f32(pred), _f32(target)
    mse = np.mean((pred - target) ** 2, axis=(-2, -1))
    return 10.0 * np.log10(max_val ** 2 / np.maximum(mse, 1e-12))


def _gaussian_window(size: int, sigma: float):
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim(pred, target, max_val: float = 1.0, window: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> Array:
    """Structural similarity (Wang et al. 2004): 11x11 Gaussian window,
    standard constants; mean over the image, batched over leading axes."""
    from scipy.signal import convolve

    pred, target = _f32(pred), _f32(target)
    squeeze = pred.ndim == 2
    if squeeze:
        pred, target = pred[None], target[None]
    lead = pred.shape[:-2]
    pred = pred.reshape((-1,) + pred.shape[-2:])      # (N, H, W)
    target = target.reshape((-1,) + target.shape[-2:])

    g = _gaussian_window(window, sigma)
    kern = np.outer(g, g)[None].astype(np.float32)    # (1, w, w)

    def f(img):
        # symmetric kernel: convolve == correlate; 'valid' drops borders
        return convolve(img, kern, mode="valid")

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_p, mu_t = f(pred), f(target)
    mu_p2, mu_t2, mu_pt = mu_p ** 2, mu_t ** 2, mu_p * mu_t
    var_p = f(pred ** 2) - mu_p2
    var_t = f(target ** 2) - mu_t2
    cov = f(pred * target) - mu_pt
    s = ((2 * mu_pt + c1) * (2 * cov + c2)
         / ((mu_p2 + mu_t2 + c1) * (var_p + var_t + c2)))
    out = s.mean(axis=(-2, -1)).reshape(lead)
    return out[0] if squeeze else out


def average_endpoint_error(pred_flow, gt_flow) -> Array:
    """AEE: mean L2 distance between flow vectors, the standard optic-flow
    accuracy metric. Inputs ``(..., 2, H, W)``; mean over pixels (and any
    leading axes)."""
    d = _f32(pred_flow) - _f32(gt_flow)
    return np.mean(np.sqrt(d[..., 0, :, :] ** 2 + d[..., 1, :, :] ** 2))
