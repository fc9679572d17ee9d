"""Contrast-maximisation objective functions (port of
``event_utils_tpu.models.objectives``).

Every objective is

1. a pure loss on the image of warped events, ``loss_fn(iwe)``, which the
   optimizers differentiate with autograd through warp → bilinear scatter →
   blur → reduction, and
2. a reference-compatible object with ``evaluate_function`` /
   ``evaluate_gradient`` whose *analytic* gradients reproduce the reference
   formulas, including which of ``iwe``/``d_iwe`` each objective blurs and
   the all-axes dIWE blur quirk.

The adaptive-lifespan mechanism is host state for the scipy-driven
optimizer and a validity-mask update (``utils.lifespan_mask``) elsewhere.
``evaluate_*`` take ``impl`` (the IWE route; 'matmul' runs the CUDA
kernels) and ``device`` (where numpy inputs go) beside the JAX arguments.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from .._device import as_f32, as_tensor, pick_device, to_numpy
from ..errors import RegistryError
from ..ops.blur import gaussian_filter
from ..representations.image import (events_to_image_drv,
                                     events_to_timestamp_image,
                                     image_to_event_weights)


# ---------------------------------------------------------------------------
# IWE factory
# ---------------------------------------------------------------------------

def iwe_validity_mask(xw, yw, img_size, mask=None):
    """Combined in-bounds test of the reference pipeline: events survive iff
    ``0 < x' < W`` and ``0 < y' < H`` (``events_bounds_mask``'s exclusive
    lower bound composed with the image clip ``x' < W``)."""
    valid = (xw > 0) & (xw < img_size[1]) & (yw > 0) & (yw < img_size[0])
    if mask is not None:
        valid = valid & (mask != 0)
    return valid


def _last_valid_t(ts, mask):
    """The last valid timestamp: a scalar, or (S, 1) where ``ts`` or
    ``mask`` has a row per sample."""
    if ts.dim() == 2 or (mask is not None and mask.dim() == 2):
        if mask is None:
            return ts[..., -1:]
        return torch.where(mask != 0, ts, -torch.inf).amax(-1, keepdim=True)
    if mask is None:
        return ts[-1]
    return torch.where(mask != 0, ts, -torch.inf).max()


def get_iwe(params, xs, ys, ts, ps, warpfunc, img_size,
            compute_gradient: bool = False, use_polarity: bool = True,
            return_events: bool = False,
            return_per_event_contrast: bool = False, mask=None, t0=None,
            impl: Optional[str] = None, device=None):
    """Warp events and form the (padded) image of warped events.

    Returns ``(iwe, d_iwe[, (x', y')][, per_event_contrast])``; ``iwe`` is
    ``(H+1, W+1)`` like the reference's padded bilinear image.

    Batched: ``params`` (S, dims) warps the events once per sample, and the
    S IWEs ``(S, H+1, W+1)`` form in one batched splat (JAX vmaps this
    function). The events and ``mask`` are then (N,), shared by every
    sample, or (S, N), one row per sample; ``t0`` defaults to each row's
    last valid timestamp. ``compute_gradient`` is per image only.

    Divergence kept from the JAX package: the reference forgets to forward
    ``img_size`` to ``events_to_image_drv`` (objectives.py:191); here the
    image is always sized from ``img_size``.
    """
    dev = pick_device(xs, ys, ts, ps, mask, device=device)
    xs = as_f32(xs, dev)
    ys = as_f32(ys, dev)
    ts = as_f32(ts, dev)
    ps = as_f32(ps, dev)
    if mask is not None:
        mask = as_tensor(mask, dev)
    if not use_polarity:
        ps = torch.abs(ps)
    if t0 is None:
        t0 = _last_valid_t(ts, mask)
    xw, yw, jx, jy = warpfunc.warp(xs, ys, ts, ps, t0, params,
                                   compute_grad=compute_gradient)
    valid = iwe_validity_mask(xw, yw, img_size, mask)
    iwe, d_iwe = events_to_image_drv(xw, yw, ps, jx, jy,
                                     sensor_size=tuple(img_size),
                                     clip_out_of_range=True,
                                     interpolation="bilinear", padding=True,
                                     compute_gradient=compute_gradient,
                                     mask=valid, impl=impl)
    out = [iwe, d_iwe]
    if return_events:
        out.append((xw * valid, yw * valid))
    if return_per_event_contrast:
        out.append(image_to_event_weights(xw, yw, iwe, mask=valid))
    return tuple(out)


# ---------------------------------------------------------------------------
# Objective base
# ---------------------------------------------------------------------------

class objective_function(ABC):
    """Base contrast objective (reference objectives.py:10-140).

    Flags: ``use_polarity``, ``has_derivative``, ``default_blur``,
    ``adaptive_lifespan``, ``pixel_crossings``, ``minimum_events``.
    ``iter_update``/``update_lifespan`` implement the per-BFGS-iteration
    event-lifespan trimming as host state.
    """

    def __init__(self, name="template", use_polarity=True, has_derivative=True,
                 default_blur=1.0, adaptive_lifespan=False, pixel_crossings=5,
                 minimum_events=10000):
        self.name = name
        self.use_polarity = use_polarity
        self.has_derivative = has_derivative
        self.default_blur = default_blur
        self.adaptive_lifespan = adaptive_lifespan
        self.pixel_crossings = pixel_crossings
        self.minimum_events = minimum_events
        self.recompute_lifespan = True
        self.lifespan = 0.5
        self.s_idx = 0
        self.num_events = None

    @abstractmethod
    def loss_fn(self, iwe: torch.Tensor) -> torch.Tensor:
        """Scalar loss of a (blurred) IWE; minimized by the optimizer."""

    # -- lifespan housekeeping (objectives.py:113-140) ---------------------
    def iter_update(self, params, pixel_crossings=None):
        pixel_crossings = (self.pixel_crossings if pixel_crossings is None
                           else pixel_crossings)
        magnitude = float(np.linalg.norm(to_numpy(params)))
        self.lifespan = 5.0 if magnitude == 0 else pixel_crossings / magnitude
        self.recompute_lifespan = True

    def update_lifespan(self, ts):
        if self.adaptive_lifespan:
            ts = to_numpy(ts)
            self.s_idx = int(np.searchsorted(ts, ts[-1] - self.lifespan))
            if len(ts) - self.s_idx < self.minimum_events:
                self.s_idx = max(len(ts) - self.minimum_events, 0)
        if self.num_events is None:
            self.num_events = len(ts) - self.s_idx

    def _lifespan_slice(self, xs, ys, ts, ps):
        """Reference adaptive-lifespan preamble (objectives.py:217-225):
        slice ``[s_idx:-1]`` and scale polarities by 100."""
        if self.recompute_lifespan:
            self.update_lifespan(ts)
            self.recompute_lifespan = False
        s = self.s_idx
        return xs[s:-1], ys[s:-1], ts[s:-1], ps[s:-1] * 100

    # -- shared evaluate machinery ----------------------------------------
    def _make_iwe(self, params, xs, ys, ts, ps, warpfunc, img_size,
                  compute_gradient, mask=None, impl=None, device=None):
        dev = pick_device(xs, ys, ts, ps, mask, device=device)
        xs, ys, ts, ps = (as_f32(a, dev) for a in (xs, ys, ts, ps))
        if self.adaptive_lifespan and mask is None:
            xs, ys, ts, ps = self._lifespan_slice(xs, ys, ts, ps)
        return get_iwe(params, xs, ys, ts, ps, warpfunc, img_size,
                       use_polarity=self.use_polarity,
                       compute_gradient=compute_gradient, mask=mask,
                       impl=impl)

    def _blur(self, arr, blur_sigma):
        sigma = self.default_blur if blur_sigma is None else blur_sigma
        if sigma and sigma > 0:
            return gaussian_filter(arr, sigma)
        return arr

    def evaluate_function(self, params=None, xs=None, ys=None, ts=None,
                          ps=None, warpfunc=None, img_size=None,
                          blur_sigma=None, showimg=False, iwe=None, mask=None,
                          impl=None, device=None):
        del showimg
        if iwe is None:
            iwe, _ = self._make_iwe(params, xs, ys, ts, ps, warpfunc,
                                    img_size, False, mask, impl, device)
        iwe = self._blur(iwe, blur_sigma)
        return float(self.loss_fn(iwe))

    def evaluate_gradient(self, params=None, xs=None, ys=None, ts=None,
                          ps=None, warpfunc=None, img_size=None,
                          blur_sigma=None, showimg=False, iwe=None,
                          d_iwe=None, mask=None, impl=None, device=None):
        """Analytic gradient; subclasses define ``_gradient(iwe, d_iwe)`` and
        ``_gradient_blur`` says which inputs get blurred (parity with the
        per-objective choices of the reference)."""
        del showimg
        if not self.has_derivative:
            return None
        if iwe is None or d_iwe is None:
            iwe, d_iwe = self._make_iwe(params, xs, ys, ts, ps, warpfunc,
                                        img_size, True, mask, impl, device)
        blur_iwe, blur_diwe = self._gradient_blur
        if blur_iwe:
            iwe = self._blur(iwe, blur_sigma)
        if blur_diwe:
            d_iwe = self._blur(d_iwe, blur_sigma)  # all-axes blur, as scipy
        return to_numpy(self._gradient(iwe, d_iwe))

    _gradient_blur = (False, True)  # (blur iwe?, blur d_iwe?)

    def _gradient(self, iwe, d_iwe):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Concrete objectives
# ---------------------------------------------------------------------------

class variance_objective(objective_function):
    """Variance of the IWE (Gallego RAL'17; reference objectives.py:202-264).
    loss = -var(IWE); grad_k = -mean(2(IWE - mean(IWE)) * dIWE_k)."""

    def __init__(self, adaptive_lifespan=False, minimum_events=10000):
        super().__init__(name="variance", use_polarity=True,
                         has_derivative=True, default_blur=1.0,
                         adaptive_lifespan=adaptive_lifespan,
                         pixel_crossings=5, minimum_events=minimum_events)

    def loss_fn(self, iwe):
        return -torch.var(iwe - torch.mean(iwe), correction=0)

    _gradient_blur = (False, True)

    def _gradient(self, iwe, d_iwe):
        img_component = 2.0 * (iwe - torch.mean(iwe))
        return -torch.mean(img_component[None] * d_iwe, dim=(1, 2))


class rms_objective(objective_function):
    """Squared L2 norm per pixel (reference objectives.py:266-306).
    loss = -||IWE||_F^2 / num_pix; grad_k = -2 mean(IWE * dIWE_k).

    Divergence kept from the JAX package: the reference's value uses the
    spectral norm (``np.linalg.norm(iwe, 2)``, objectives.py:289),
    inconsistent with its own Frobenius gradient; Frobenius is implemented.
    """

    def __init__(self):
        super().__init__(name="rms", use_polarity=True, has_derivative=True,
                         default_blur=1.0)

    def loss_fn(self, iwe):
        return -torch.sum(iwe * iwe) / (iwe.shape[0] * iwe.shape[1])

    _gradient_blur = (False, True)

    def _gradient(self, iwe, d_iwe):
        return -2.0 * torch.mean(iwe[None] * d_iwe, dim=(1, 2))


class sos_objective(objective_function):
    """Sum of squares (Stoffregen CVPR'19; reference objectives.py:308-356).
    loss = -mean(IWE^2); grad_k = -mean(2 IWE dIWE_k)."""

    def __init__(self, adaptive_lifespan=False, minimum_events=10000):
        super().__init__(name="sos", use_polarity=True, has_derivative=True,
                         default_blur=1.0, adaptive_lifespan=adaptive_lifespan,
                         pixel_crossings=5, minimum_events=minimum_events)
        self.div = 1.0

    def loss_fn(self, iwe):
        return -torch.mean(iwe * iwe)

    _gradient_blur = (False, True)

    def _gradient(self, iwe, d_iwe):
        img_component = iwe * 2.0 / (self.div * self.div)
        return -torch.mean(d_iwe * img_component[None], dim=(1, 2))


class soe_objective(objective_function):
    """Sum of exponentials (reference objectives.py:358-399); polarity off.
    loss = -mean(exp(IWE)); grad_k = -mean(exp(IWE) dIWE_k), both images
    blurred."""

    def __init__(self):
        super().__init__(name="soe", use_polarity=False, has_derivative=True,
                         default_blur=2.5)

    def loss_fn(self, iwe):
        return -torch.mean(torch.exp(iwe))

    _gradient_blur = (True, True)

    def _gradient(self, iwe, d_iwe):
        return -torch.mean(torch.exp(iwe)[None] * d_iwe, dim=(1, 2))


class moa_objective(objective_function):
    """Max of accumulations (reference objectives.py:401-429); no analytic
    derivative. loss = -max(IWE)."""

    def __init__(self):
        super().__init__(name="moa", use_polarity=False, has_derivative=False,
                         default_blur=3.0)

    def loss_fn(self, iwe):
        return -torch.max(iwe)


class isoa_objective(objective_function):
    """(Negated) inverse sum of accumulations (reference objectives.py:431-476).
    loss = sum(IWE > thresh); grad_k = -sum(dIWE_k * [IWE > thresh]).

    ``loss_fn`` is the hard threshold (parity); the autodiff path optimizes
    the sigmoid surrogate ``soft_loss_fn``, since the indicator has zero
    gradient almost everywhere.
    """

    def __init__(self, thresh=0.5):
        super().__init__(name="isoa", use_polarity=False, has_derivative=True,
                         default_blur=1.0)
        self.thresh = thresh

    def loss_fn(self, iwe):
        return torch.sum((iwe > self.thresh).to(iwe.dtype))

    def soft_loss_fn(self, iwe, temperature=0.1):
        return torch.sum(torch.sigmoid((iwe - self.thresh) / temperature))

    _gradient_blur = (True, True)

    def _gradient(self, iwe, d_iwe):
        ind = (iwe > self.thresh).to(iwe.dtype)
        return -torch.sum(d_iwe * ind[None], dim=(1, 2))


class sosa_objective(objective_function):
    """Sum of suppressed accumulations (reference objectives.py:478-522).
    loss = -sum(exp(-p*IWE)); grad_k = -sum(dIWE_k * (-p exp(-p IWE)))."""

    def __init__(self, p=3):
        super().__init__(name="sosa", use_polarity=False, has_derivative=True,
                         default_blur=2.0)
        self.p = p

    def loss_fn(self, iwe):
        return -torch.sum(torch.exp(-self.p * iwe))

    _gradient_blur = (True, True)

    def _gradient(self, iwe, d_iwe):
        fx = -self.p * torch.exp(-self.p * iwe)
        return -torch.sum(d_iwe * fx[None], dim=(1, 2))


class zhu_timestamp_objective(objective_function):
    """Squared average-timestamp images (Zhu CVPR'19; reference
    objectives.py:524-558): loss = +(sum(T_pos^2) + sum(T_neg^2)) over the
    blurred timestamp images of the warped events — minimized at motion
    compensation, as in the cited paper.

    Divergences kept from the JAX package: the reference calls an undefined
    ``events_to_zhu_timestamp_image`` (the intended
    ``events_to_timestamp_image`` is used), and it negates the sum, which
    makes a minimizer run away from motion compensation (the paper's sign
    is implemented).
    """

    def __init__(self):
        super().__init__(name="zhu", use_polarity=True, has_derivative=False,
                         default_blur=2.0)

    def loss_fn(self, iwe):
        return torch.sum(iwe * iwe)

    def make_event_loss(self, warpfunc, img_size, blur_sigma, impl=None):
        """Differentiable zhu loss straight from events: the timestamp
        images are bilinear scatters of the warped coordinates, so autograd
        flows end to end. ``impl='matmul'`` builds all 4 accumulations in
        one launch of the CUDA bilinear kernel. (S, dims) params give (S,)
        losses from one batched K=4 launch (the events as in ``get_iwe``),
        each image blurred over its own axes."""
        sigma = self.default_blur if blur_sigma is None else blur_sigma

        def reduce(pos, neg):
            return torch.sum(pos * pos) + torch.sum(neg * neg)

        def loss(params, xs, ys, ts, ps, mask=None):
            ts = as_f32(ts, pick_device(xs, ys, ts, ps, mask))
            t0 = _last_valid_t(ts, mask)
            xw, yw, _, _ = warpfunc.warp(xs, ys, ts, ps, t0, params,
                                         compute_grad=False)
            valid = iwe_validity_mask(xw, yw, img_size, mask)
            pos, neg = events_to_timestamp_image(
                xw, yw, ts, ps, sensor_size=tuple(img_size), mask=valid,
                impl=impl)
            if sigma and sigma > 0:
                pos = gaussian_filter(pos, sigma, axes=(-2, -1))
                neg = gaussian_filter(neg, sigma, axes=(-2, -1))
            return (torch.func.vmap(reduce) if pos.dim() == 3 else reduce)(
                pos, neg)

        return loss

    def evaluate_function(self, params=None, xs=None, ys=None, ts=None,
                          ps=None, warpfunc=None, img_size=None,
                          blur_sigma=None, showimg=False, iwe=None, mask=None,
                          impl=None, device=None):
        del showimg
        if iwe is None:
            dev = pick_device(xs, ys, ts, ps, mask, device=device)
            xs, ys, ts, ps = (as_f32(a, dev) for a in (xs, ys, ts, ps))
            if mask is not None:
                mask = as_tensor(mask, dev)
            t0 = _last_valid_t(ts, mask)
            xw, yw, _, _ = warpfunc.warp(xs, ys, ts, ps, t0, params,
                                         compute_grad=False)
            valid = iwe_validity_mask(xw, yw, img_size, mask)
            posimg, negimg = events_to_timestamp_image(
                xw, yw, ts, ps, sensor_size=tuple(img_size), mask=valid,
                impl=impl)
        else:
            posimg, negimg = iwe
        posimg = self._blur(posimg, blur_sigma)
        negimg = self._blur(negimg, blur_sigma)
        return float(torch.sum(posimg * posimg) + torch.sum(negimg * negimg))


class r1_objective(objective_function):
    """R1 = SOS * SOSA composite (reference objectives.py:560-596) with the
    monotonic-SOSA gate: while SOSA keeps rising, only -SOS is returned."""

    def __init__(self, p=3):
        super().__init__(name="r1", use_polarity=False, has_derivative=False,
                         default_blur=1.0)
        self.p = p
        self.last_sosa = 0.0

    def loss_fn(self, iwe):
        """Stateless product form (the optimizers' loss surface)."""
        sos = torch.mean(iwe * iwe)
        sosa = torch.sum(torch.exp(-self.p * iwe))
        return -sos * sosa

    def evaluate_function(self, params=None, xs=None, ys=None, ts=None,
                          ps=None, warpfunc=None, img_size=None,
                          blur_sigma=None, showimg=False, iwe=None, mask=None,
                          impl=None, device=None):
        del showimg
        if iwe is None:
            iwe, _ = self._make_iwe(params, xs, ys, ts, ps, warpfunc,
                                    img_size, False, mask, impl, device)
        iwe = self._blur(iwe, blur_sigma)
        sos = float(torch.mean(iwe * iwe))
        sosa = float(torch.sum(torch.exp(-self.p * iwe)))
        # reference-parity quirk (objectives.py:571-589): last_sosa starts at
        # 0 and sosa > 0 always, so the gate never closes and this host API
        # returns plain -sos; the optimizers use loss_fn above
        if sosa > self.last_sosa:
            return -sos
        self.last_sosa = sosa
        return -sos * sosa


OBJECTIVE_REGISTRY = {
    "variance": variance_objective,
    "rms": rms_objective,
    "sos": sos_objective,
    "soe": soe_objective,
    "moa": moa_objective,
    "isoa": isoa_objective,
    "sosa": sosa_objective,
    "zhu": zhu_timestamp_objective,
    "r1": r1_objective,
}


def get_objective(name: str, **kwargs) -> objective_function:
    """Explicit registry lookup by objective name."""
    try:
        return OBJECTIVE_REGISTRY[name](**kwargs)
    except KeyError:
        raise RegistryError(
            f"Unknown objective {name!r}; have {sorted(OBJECTIVE_REGISTRY)}")
