"""Dense event-image representations: event image, timestamp image, IWE
(port of ``event_utils_tpu.representations.image``).

Masking policy as in the JAX package: by default out-of-bounds events are
*dropped* (zero contribution); ``legacy_mask=True`` reproduces the
reference's coordinate-zeroing trick (image.py:83-85, 94) including its
quirks (the integer route dumps the unmasked weight onto pixel (0, 0)).

The stateful ``EventImage``/``TimestampImage`` accumulators are host numpy,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import as_f32, as_tensor, pick_device
from ..ops.scatter import (
    bilinear_gather,
    bilinear_scatter,
    bilinear_scatter_derivative,
    scatter_add_2d,
)
from ..ops.cuda_scatter import bilinear_matmul, bilinear_matmul_batched

_MATMUL_IMPLS = ("matmul", "matmul_hilo", "matmul_bf16")


def _legacy_clip_mask(xs, ys, clipx, clipy):
    """Upper-bound-only clip mask of reference image.py:73-75."""
    return (~(xs >= clipx) & ~(ys >= clipy)).to(torch.float32)


def _mask_tensor(mask, dev):
    return None if mask is None else as_tensor(mask, dev)


def events_to_image_torch(xs, ys, ps, device=None, sensor_size=(180, 240),
                          clip_out_of_range: bool = True,
                          interpolation: Optional[str] = None,
                          padding: bool = True, default: float = 0,
                          mask=None, legacy_mask: bool = False,
                          impl: Optional[str] = None) -> torch.Tensor:
    """Accumulate events into an image (reference image.py:46-100 semantics).

    Bilinear + padding returns the *padded* ``(H+1, W+1)`` image, exactly
    like the reference.
    """
    H, W = sensor_size
    dev = pick_device(xs, ys, ps, mask, device=device)
    bilinear = interpolation == "bilinear"
    xs = as_f32(xs, dev) if bilinear else as_tensor(xs, dev)
    ys = as_f32(ys, dev) if bilinear else as_tensor(ys, dev)
    ps = as_f32(ps, dev)
    mask = _mask_tensor(mask, dev)

    img_size = (H + 1, W + 1) if bilinear and padding else (H, W)

    if bilinear:
        clipx = img_size[1] - 1
        clipy = img_size[0] - 1
        if legacy_mask and clip_out_of_range:
            m = _legacy_clip_mask(xs, ys, clipx, clipy)
            if mask is not None:
                m = m * mask
            # reference: pxs = floor(x)*mask, residuals unmasked, weights
            # masked (image.py:79-86)
            px = torch.floor(xs) * m
            py = torch.floor(ys) * m
            dx = xs - torch.floor(xs)
            dy = ys - torch.floor(ys)
            img = bilinear_scatter(px + dx, py + dy, ps * m, img_size,
                                   impl=impl)
        else:
            m = mask
            if clip_out_of_range:
                valid = (xs < clipx) & (ys < clipy) & (xs >= 0) & (ys >= 0)
                m = valid if m is None else (m != 0) & valid
            img = bilinear_scatter(xs, ys, ps, img_size, mask=m, impl=impl)
    else:
        # integer route (image.py:87-95): coords truncated toward zero
        if legacy_mask and clip_out_of_range:
            clipx = img_size[1] if not padding else img_size[1] - 1
            clipy = img_size[0] if not padding else img_size[0] - 1
            m = _legacy_clip_mask(xs, ys, clipx, clipy)
            if mask is not None:
                m = m * mask
            mi = m.long()
            ixs = torch.trunc(xs.to(torch.float32)).long() * mi
            iys = torch.trunc(ys.to(torch.float32)).long() * mi
            # reference does NOT mask ps here (image.py:95): out-of-range
            # events dump their weight onto pixel (0, 0)
            img = scatter_add_2d(ixs, iys, ps, img_size, impl=impl)
        else:
            img = scatter_add_2d(xs, ys, ps, img_size, mask=mask, impl=impl)

    if default != 0:
        img = img + default * (img == 0)
    return img


def events_to_image(xs, ys, ps, sensor_size=(180, 240),
                    interpolation: Optional[str] = None, padding: bool = False,
                    meanval: bool = False, default: float = 0, mask=None,
                    impl: Optional[str] = None, device=None) -> torch.Tensor:
    """Accumulate events into an ``(H, W)`` image (reference image.py:5-44).

    The integer route scatters into a padded ``(H+1, W+1)`` grid then crops,
    so events at exactly ``x == W`` / ``y == H`` are discarded, matching the
    numpy reference. ``meanval`` divides by the per-pixel event count
    (``default`` where the count is zero).
    """
    H, W = sensor_size
    dev = pick_device(xs, ys, ps, mask, device=device)
    mask = _mask_tensor(mask, dev)
    if interpolation == "bilinear":
        img = events_to_image_torch(xs, ys, ps, device=dev,
                                    sensor_size=sensor_size,
                                    clip_out_of_range=True,
                                    interpolation="bilinear", padding=padding,
                                    mask=mask, impl=impl)
        img = torch.where(img == 0, float(default), img)
        if meanval:
            # count events at their integer pixel on the image's own grid,
            # only those the numerator's bilinear clip kept
            fxs = as_f32(xs, dev)
            fys = as_f32(ys, dev)
            clipx = float(W if padding else W - 1)
            clipy = float(H if padding else H - 1)
            valid = ((fxs >= 0) & (fys >= 0) & (fxs < clipx)
                     & (fys < clipy)).to(torch.float32)
            if mask is not None:
                valid = valid * mask.to(torch.float32)
            cnt = scatter_add_2d(torch.floor(fxs), torch.floor(fys),
                                 torch.ones_like(fxs), tuple(img.shape),
                                 mask=valid, impl=impl)
    else:
        img_size = (H + 1, W + 1)
        xs_t = as_tensor(xs, dev)
        img = scatter_add_2d(xs_t, ys, as_f32(ps, dev), img_size, mask=mask,
                             impl=impl, device=dev)
        if meanval:
            cnt = scatter_add_2d(xs_t, ys, torch.ones(xs_t.shape, device=dev),
                                 img_size, mask=mask, impl=impl, device=dev)
    if meanval:
        cnt = cnt[:img.shape[0], :img.shape[1]]
        img = torch.where(cnt != 0, img / torch.where(cnt == 0, 1.0, cnt),
                          float(default))
    return img[0:H, 0:W]


# ---------------------------------------------------------------------------
# IWE + analytic derivative images
# ---------------------------------------------------------------------------

def events_to_image_drv(xn, yn, pn, jacobian_xn, jacobian_yn,
                        sensor_size=(180, 240), clip_out_of_range: bool = True,
                        interpolation: str = "bilinear", padding: bool = True,
                        compute_gradient: bool = False, mask=None,
                        legacy_mask: bool = False, impl: Optional[str] = None,
                        device=None):
    """Image of (warped) events + analytic dIWE/dparams stack
    (reference image.py:162-217).

    Returns ``(iwe, d_iwe)``; ``d_iwe`` is ``(D, H+1, W+1)`` (``None`` if
    ``compute_gradient=False``). Differentiable through the scatter.
    (S, N) coordinates (the events warped by S parameter samples; ``pn``
    and ``mask`` (N,) or (S, N)) give S images in one batched splat, the
    IWE ``(S, H+1, W+1)``; the dIWE stack is per image only.
    """
    H, W = sensor_size
    dev = pick_device(xn, yn, pn, mask, device=device)
    xs = as_f32(xn, dev)
    ys = as_f32(yn, dev)
    ps = as_f32(pn, dev)
    mask = _mask_tensor(mask, dev)
    img_size = (H + 1, W + 1) if padding else (H, W)
    clipx, clipy = img_size[1] - 1, img_size[0] - 1

    if legacy_mask and clip_out_of_range:
        m = _legacy_clip_mask(xs, ys, clipx, clipy)
        if mask is not None:
            m = m * mask
        px = torch.floor(xs) * m
        py = torch.floor(ys) * m
        dx = xs - torch.floor(xs)
        dy = ys - torch.floor(ys)
        wx, wy, wp, wm = px + dx, py + dy, ps * m, None
    else:
        m = mask
        if clip_out_of_range:
            valid = (xs < clipx) & (ys < clipy) & (xs >= 0) & (ys >= 0)
            m = valid if m is None else (m != 0) & valid
        wx, wy, wp, wm = xs, ys, ps, m

    iwe = bilinear_scatter(wx, wy, wp, img_size, mask=wm, impl=impl)
    d_iwe = None
    if compute_gradient:
        jx = as_f32(jacobian_xn, dev)
        jy = as_f32(jacobian_yn, dev)
        d_iwe = bilinear_scatter_derivative(wx, wy, jx, jy, wp, img_size,
                                            mask=wm, impl=impl)
    return iwe, d_iwe


def image_to_event_weights(xs, ys, img, mask=None,
                           device=None) -> torch.Tensor:
    """Per-event image values via bilinear gather (reference
    image.py:138-160); events beyond the image get 0."""
    dev = pick_device(img, xs, ys, mask, device=device)
    img = as_tensor(img, dev)
    H, W = img.shape[-2], img.shape[-1]
    xs = as_f32(xs, dev)
    ys = as_f32(ys, dev)
    valid = (xs < W - 1) & (ys < H - 1) & (xs >= 0) & (ys >= 0)
    if mask is not None:
        valid = valid & (as_tensor(mask, dev) != 0)
    return bilinear_gather(xs, ys, img, mask=valid)


# ---------------------------------------------------------------------------
# Average-timestamp images (Zhu, CVPR'19)
# ---------------------------------------------------------------------------

def _timestamp_weight_sums(xs, ys, normalized_ts, ps, mask, img_size,
                           clipx, clipy, clip_out_of_range, legacy_mask,
                           impl):
    """The four raw accumulations behind the timestamp image,
    ``(ts*pos, pos, ts*neg, neg)`` as a (4, H', W') stack, before the count
    division; (S, 4, H', W') for (S, N) coordinates. The kernel routes
    build all four in ONE bilinear launch (K=4 channels sharing the
    coordinates; for S samples one batched K=4 launch)."""
    pos_mask = (ps > 0).to(torch.float32)
    neg_mask = (ps <= 0).to(torch.float32)
    if mask is not None:
        pos_mask = pos_mask * mask
        neg_mask = neg_mask * mask

    if legacy_mask and clip_out_of_range:
        m = _legacy_clip_mask(xs, ys, clipx, clipy)
        if mask is not None:
            m = m * mask
        # reference zeroes coords but NOT the count/ts weights
        # (image.py:267-277): clipped events pile up at pixel (0, 0)
        px = torch.floor(xs) * m
        py = torch.floor(ys) * m
        dx = xs - torch.floor(xs)
        dy = ys - torch.floor(ys)
        gx, gy, gm = px + dx, py + dy, None
    else:
        gm = ((xs < clipx) & (ys < clipy) & (xs >= 0) & (ys >= 0)
              if clip_out_of_range else None)
        gx, gy = xs, ys

    samples = gx.dim() == 2
    weights = torch.stack(torch.broadcast_tensors(
        normalized_ts * pos_mask, pos_mask, normalized_ts * neg_mask,
        neg_mask), dim=-2)
    if gm is not None:
        weights = weights * gm.to(weights.dtype).unsqueeze(-2)

    if impl in _MATMUL_IMPLS:
        splat = bilinear_matmul_batched if samples else bilinear_matmul
        return splat(gx, gy, weights, img_size,
                     precision="bf16" if impl == "matmul_bf16" else "hilo")
    return torch.stack([bilinear_scatter(gx, gy, w, img_size, impl=impl)
                        for w in weights.unbind(-2)], dim=-3)


def events_to_timestamp_image(xn, yn, ts, pn, sensor_size=(180, 240),
                              clip_out_of_range: bool = True,
                              interpolation: str = "bilinear",
                              padding: bool = True,
                              normalize_timestamps: bool = True,
                              timestamp_reverse: bool = False, mask=None,
                              legacy_mask: bool = False,
                              impl: Optional[str] = None, device=None):
    """Average-timestamp images of positive / negative events
    (reference image.py:219-353).

    ``interpolation`` only selects the clip bounds: events always splat
    bilinearly, as in the reference. Count images start at *ones*, so the
    average is ``Σ(t·w) / (1 + Σw)``. Returns ``(img_pos, img_neg)``,
    padded ``(H+1, W+1)`` when ``padding``. (S, N) coordinates (S warps of
    the events; ``ts``, ``pn`` and ``mask`` (N,) or (S, N)) give (S, H', W')
    images, each sample's timestamps normalised over its own valid events.
    """
    H, W = sensor_size
    dev = pick_device(xn, yn, ts, pn, mask, device=device)
    xs = as_f32(xn, dev)
    ys = as_f32(yn, dev)
    ts = as_f32(ts, dev)
    ps = as_f32(pn, dev)
    mask = _mask_tensor(mask, dev)
    img_size = (H + 1, W + 1) if padding else (H, W)
    if interpolation == "bilinear" or padding:
        clipx, clipy = img_size[1] - 1, img_size[0] - 1
    else:
        clipx, clipy = img_size[1], img_size[0]

    eps = 1e-6
    big = torch.finfo(torch.float32).max
    if xs.dim() == 2:  # per sample: (S, 1)
        if mask is None:
            t_first, t_last = ts[..., :1], ts[..., -1:]
        else:
            t_first = torch.where(mask != 0, ts, big).amin(-1, keepdim=True)
            t_last = torch.where(mask != 0, ts, -big).amax(-1, keepdim=True)
    elif mask is None:
        t_first, t_last = ts[0], ts[-1]
    else:
        t_first = torch.where(mask != 0, ts, big).min()
        t_last = torch.where(mask != 0, ts, -big).max()
    if timestamp_reverse:
        normalized_ts = (-ts + t_last) / (t_last - t_first + eps)
    elif normalize_timestamps:
        normalized_ts = (ts - t_first) / (t_last - t_first + eps)
    else:
        normalized_ts = ts

    if mask is not None:
        mask = mask.to(torch.float32)
    stack = _timestamp_weight_sums(xs, ys, normalized_ts, ps, mask, img_size,
                                   clipx, clipy, clip_out_of_range,
                                   legacy_mask, impl)
    img_pos, img_neg = stack[..., 0, :, :], stack[..., 2, :, :]
    img_pos_cnt = 1.0 + stack[..., 1, :, :]
    img_neg_cnt = 1.0 + stack[..., 3, :, :]
    img_pos = img_pos / torch.where(img_pos_cnt == 0, 1.0, img_pos_cnt)
    img_neg = img_neg / torch.where(img_neg_cnt == 0, 1.0, img_neg_cnt)
    return img_pos, img_neg


def interpolate_to_image(pxs, pys, dxs, dys, weights, img):
    """Signature-compatible shim for the reference's hot kernel
    (image.py:102-115): bilinear taps of ``weights`` at ``(pxs + dxs,
    pys + dys)`` added to ``img``. As in the JAX package the updated image
    is *returned* (``img`` is not modified); prefer ``ops.bilinear_scatter``
    in new code."""
    img = torch.as_tensor(img)
    dev = img.device
    x = as_f32(pxs, dev) + as_f32(dxs, dev)
    y = as_f32(pys, dev) + as_f32(dys, dev)
    return img + bilinear_scatter(x, y, as_f32(weights, dev),
                                  tuple(img.shape))


def interpolate_to_derivative_img(pxs, pys, dxs, dys, d_img, w1, w2):
    """Signature-compatible shim for reference image.py:117-136: returns
    ``d_img`` plus the (2, H, W) derivative images of the Jacobian weights
    ``w1``, ``w2`` (see ``ops.bilinear_scatter_derivative``)."""
    d_img = torch.as_tensor(d_img)
    dev = d_img.device
    x = as_f32(pxs, dev) + as_f32(dxs, dev)
    y = as_f32(pys, dev) + as_f32(dys, dev)
    return d_img + bilinear_scatter_derivative(
        x, y, as_f32(w1, dev), as_f32(w2, dev), torch.ones_like(x),
        tuple(d_img.shape[1:]))


def events_to_timestamp_image_torch(xs, ys, ts, ps, device=None,
                                    sensor_size=(180, 240),
                                    clip_out_of_range=True,
                                    interpolation="bilinear", padding=True,
                                    timestamp_reverse=False, **kw):
    """Signature-compatible alias of the reference's torch entry point
    (image.py:286-353); ``device`` is where the images are built."""
    return events_to_timestamp_image(xs, ys, ts, ps, sensor_size=sensor_size,
                                     clip_out_of_range=clip_out_of_range,
                                     interpolation=interpolation,
                                     padding=padding,
                                     timestamp_reverse=timestamp_reverse,
                                     device=device, **kw)


class TimestampImage:
    """Online last-timestamp image; ``get_image`` rank-normalises
    (reference image.py:355-377, vectorised; the last event per pixel
    wins). Host numpy."""

    def __init__(self, sensor_size):
        self.sensor_size = tuple(sensor_size)
        self.num_pixels = sensor_size[0] * sensor_size[1]
        self.image = np.ones(self.sensor_size)

    def set_init(self, value):
        self.image = np.ones_like(self.image) * value

    def add_event(self, x, y, t, p):
        self.image[int(y), int(x)] = t

    def add_events(self, xs, ys, ts, ps):
        np_xs = np.asarray(xs).astype(int)
        np_ys = np.asarray(ys).astype(int)
        self.image[np_ys, np_xs] = np.asarray(ts)  # last write wins

    def get_image(self):
        # dense ranking (scipy.stats.rankdata(method='dense') - 1)
        _, inv = np.unique(self.image.ravel(), return_inverse=True)
        ranks = inv.reshape(self.sensor_size).astype(np.float64)
        return ranks / max(ranks.max(), 1)


class EventImage:
    """Online polarity-accumulation image (reference image.py:379-396).
    Host numpy."""

    def __init__(self, sensor_size):
        self.sensor_size = tuple(sensor_size)
        self.num_pixels = sensor_size[0] * sensor_size[1]
        self.image = np.ones(self.sensor_size)

    def add_event(self, x, y, t, p):
        self.image[int(y), int(x)] += p

    def add_events(self, xs, ys, ts, ps):
        np.add.at(self.image, (np.asarray(ys).astype(int),
                               np.asarray(xs).astype(int)), np.asarray(ps))

    def get_image(self):
        mn, mx = self.image.min(), self.image.max()
        return (self.image - mn) / max(mx - mn, 1e-12)
