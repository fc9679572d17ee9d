"""Contrast-maximisation drivers: gradient optimizers and grid search
(port of ``event_utils_tpu.contrast_max.events_cmax``, its lines 40-505).

Two paths, as in the JAX package:

* **Host-driven parity path** — ``optimize_contrast`` / ``optimize`` /
  ``optimize_r2`` keep the reference's scipy-BFGS driver semantics
  (reference events_cmax.py:313-389), including the per-iteration
  adaptive-lifespan callback. ``fprime`` is torch autograd through the
  scatter kernels.
* **Whole-solve path** — ``optimize_contrast_jit`` runs the coarse-to-fine
  grid search and a BFGS (``contrast_max.bfgs``, a port of
  ``jax.scipy.optimize.minimize``) with every evaluation on the device.

Divergence from the JAX package: the scipy driver and the SOFAS grid search
form the IWE with the 'matmul' route (``DEFAULT_IWE_IMPL``), the
hand-written CUDA bilinear kernel on the card, as ``optimize_contrast_jit``
does by default. (The JAX host path used the exact XLA scatter; on the card
that would be ``index_add_``, which computes the same f32 sums.) On CPU
tensors 'matmul' is the kernel's plain f32 version.

Not yet ported: ``make_patch_loss``, ``grid_cmax_batched``, ``grid_cmax``
and the rest of the module.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.optimize as sciopt
import torch

from .._device import as_f32, as_tensor, pick_device, to_numpy
from ..errors import ConfigurationError
from ..models.objectives import get_iwe, objective_function, soe_objective
from ..models.warps import linvel_warp, warp_function
from ..ops.blur import gaussian_filter
from ..utils.event_util import lifespan_mask
from .bfgs import minimize_bfgs

DEFAULT_IWE_IMPL = "matmul"


def make_objective_loss(objective: objective_function,
                        warpfunc: warp_function,
                        img_size: Tuple[int, int],
                        blur_sigma: Optional[float],
                        iwe_impl: Optional[str] = None) -> Callable:
    """Pure ``loss(params, xs, ys, ts, ps, mask)`` for an objective/warp
    pair (the autograd path). ``iwe_impl='matmul'`` forms the IWE with the
    CUDA bilinear kernel.

    Objectives that are not plain IWE reductions define ``make_event_loss``
    (zhu's timestamp-image loss) and get their true loss here. Objectives
    whose exact loss has zero gradient almost everywhere define
    ``soft_loss_fn`` (isoa's sigmoid surrogate), which is optimized here;
    report parity-exact values via ``objective.evaluate_function``.
    """
    if hasattr(objective, "make_event_loss"):
        return objective.make_event_loss(warpfunc, img_size, blur_sigma,
                                         impl=iwe_impl)
    reduce_fn = getattr(objective, "soft_loss_fn", objective.loss_fn)

    def loss(params, xs, ys, ts, ps, mask=None):
        iwe, _ = get_iwe(params, xs, ys, ts, ps, warpfunc, img_size,
                         use_polarity=objective.use_polarity, mask=mask,
                         impl=iwe_impl)
        if blur_sigma and blur_sigma > 0:
            iwe = gaussian_filter(iwe, blur_sigma)
        return reduce_fn(iwe)

    return loss


def _events(xs, ys, ts, ps, device):
    """The four event arrays as float32 tensors on one device."""
    dev = pick_device(xs, ys, ts, ps, device=device)
    return dev, tuple(as_f32(a, dev) for a in (xs, ys, ts, ps))


def _value_and_grad(loss, dev):
    """Host-tensor ``value_and_grad`` for ``minimize_bfgs``: moves the
    parameters to ``dev``, runs ``loss`` and its autograd backward there,
    and brings the value and gradient back."""

    def vg(p):
        p = p.detach().to(dev).requires_grad_(True)
        f = loss(p)
        (g,) = torch.autograd.grad(f, p)
        return f.detach().to("cpu", torch.float32), g.to("cpu", torch.float32)

    return vg


# ---------------------------------------------------------------------------
# Host-driven optimizer (reference semantics)
# ---------------------------------------------------------------------------

def optimize_contrast(xs, ys, ts, ps, warp_function, objective,
                      optimizer=sciopt.fmin_bfgs, x0=None,
                      numeric_grads: bool = False, blur_sigma=None,
                      img_size=(180, 240), grid_search_init: bool = False,
                      minimum_events: Optional[int] = None, device=None):
    """Optimize warp parameters with a (scipy) BFGS driver
    (reference events_cmax.py:313-346).

    Adaptive lifespan runs as in the reference: the BFGS callback
    (``objective.iter_update``) recomputes the lifespan from the current
    parameter magnitude; the cut is a validity-mask update over the whole
    batch, with the reference's ``ps*100`` rescale (objectives.py:225).
    ``minimum_events`` (None: the objective's own) floors the events the
    lifespan mask keeps.
    """
    dev, (dxs, dys, dts, dps) = _events(xs, ys, ts, ps, device)

    if grid_search_init and x0 is None:
        init_obj = copy.deepcopy(objective)
        init_obj.adaptive_lifespan = False
        minv = grid_search_optimisation(dxs, dys, dts, dps, warp_function,
                                        init_obj, img_size, log_scale=False)
        x0 = minv["min_params"]
    if x0 is None:
        x0 = np.zeros(warp_function.dims)
    x0 = np.asarray(x0, np.float64)

    sigma = objective.default_blur if blur_sigma is None else blur_sigma
    loss = make_objective_loss(objective, warp_function, tuple(img_size),
                               float(sigma), iwe_impl=DEFAULT_IWE_IMPL)
    state = {"mask": torch.ones_like(dts)}
    min_events = (objective.minimum_events if minimum_events is None
                  else int(minimum_events))

    def refresh_mask(params):
        if objective.adaptive_lifespan:
            objective.iter_update(params)
            state["mask"] = lifespan_mask(
                dts, torch.as_tensor(params, dtype=torch.float32, device=dev),
                objective.pixel_crossings, min_events)

    def weights():
        return dps * 100.0 if objective.adaptive_lifespan else dps

    def params_t(p):
        return torch.as_tensor(np.asarray(p), dtype=torch.float32, device=dev)

    def f(p):
        with torch.no_grad():
            return float(loss(params_t(p), dxs, dys, dts, weights(),
                              state["mask"]))

    def fprime(p):
        pt = params_t(p).requires_grad_(True)
        (g,) = torch.autograd.grad(
            loss(pt, dxs, dys, dts, weights(), state["mask"]), pt)
        return to_numpy(g).astype(np.float64)

    refresh_mask(x0)
    if numeric_grads:
        argmax = optimizer(f, x0, epsilon=1, disp=False,
                           callback=refresh_mask)
    else:
        argmax = optimizer(f, x0, fprime=fprime, disp=False,
                           callback=refresh_mask)
    return np.asarray(argmax)


def optimize(xs, ys, ts, ps, warp, obj, numeric_grads: bool = True,
             img_size=(180, 240), device=None):
    """Single-stage optimize with blur 1.0 (reference events_cmax.py:348-368)."""
    numeric_grads = numeric_grads if obj.has_derivative else True
    return optimize_contrast(xs, ys, ts, ps, warp, obj,
                             numeric_grads=numeric_grads, blur_sigma=1.0,
                             img_size=img_size, device=device)


def optimize_r2(xs, ys, ts, ps, warp, obj, numeric_grads: bool = True,
                img_size=(180, 240), device=None):
    """Two-stage schedule finishing with the SoE loss
    (reference events_cmax.py:370-389)."""
    soe_obj = soe_objective()
    numeric_grads = numeric_grads if obj.has_derivative else True
    argmax = optimize_contrast(xs, ys, ts, ps, warp, obj,
                               numeric_grads=numeric_grads, blur_sigma=None,
                               img_size=img_size, device=device)
    return optimize_contrast(xs, ys, ts, ps, warp, soe_obj, x0=argmax,
                             numeric_grads=numeric_grads, blur_sigma=1.0,
                             img_size=img_size, device=device)


# ---------------------------------------------------------------------------
# Whole-solve optimizer
# ---------------------------------------------------------------------------

def optimize_contrast_jit(xs, ys, ts, ps, warpfunc, objective, x0=None,
                          blur_sigma: Optional[float] = 1.0,
                          img_size=(180, 240), mask=None,
                          grid_search_init: bool = False, maxiter: int = 100,
                          iwe_impl: Optional[str] = DEFAULT_IWE_IMPL,
                          device=None):
    """Grid search + BFGS with every evaluation on the device (counterpart
    of the JAX whole-solve ``optimize_contrast_jit``).

    warp → CUDA bilinear scatter (``iwe_impl='matmul'``) → blur → loss,
    differentiated by autograd and iterated by ``contrast_max.bfgs`` with
    JAX's line search, ``maxiter`` and ``gtol=1e-6``. Returns the optimal
    parameters as a float32 host tensor.
    """
    loss = make_objective_loss(objective, warpfunc, img_size, blur_sigma,
                               iwe_impl=iwe_impl)
    dev, (xs, ys, ts, ps) = _events(xs, ys, ts, ps, device)
    if mask is not None:
        mask = as_tensor(mask, dev)

    def loss_p(p):
        return loss(p, xs, ys, ts, ps, mask)

    if x0 is None:
        if grid_search_init:
            # Collapse-prone objectives (zhu, isoa, sosa) reach their global
            # optimum by sweeping every event off the sensor: cap the init
            # search at velocities that would evacuate the frame within the
            # window. Mass-preserving objectives keep the full +-150 range.
            init_range = 150.0
            if (isinstance(warpfunc, linvel_warp)
                    and getattr(objective, "name", "")
                    in ("zhu", "isoa", "sosa")):
                if mask is None:
                    dt = ts[-1] - ts[0]
                else:
                    dt = (torch.where(mask != 0, ts, -torch.inf).max()
                          - torch.where(mask != 0, ts, torch.inf).min())
                vmax = (min(img_size) / 2.0) / torch.clamp(dt, min=1e-3)
                init_range = torch.clamp(vmax, max=150.0)
            x0 = grid_search_refine(loss_p, warpfunc.dims,
                                    init_range=init_range, device=dev)[0]
        else:
            x0 = torch.zeros((warpfunc.dims,), dtype=torch.float32)
    res = minimize_bfgs(_value_and_grad(loss_p, dev), as_f32(x0, dev),
                        maxiter=maxiter, gtol=1e-6)
    return res.x_k


# ---------------------------------------------------------------------------
# SOFAS grid search
# ---------------------------------------------------------------------------

def _sample_scale(num_samples_per_param: int, log_scale: bool) -> np.ndarray:
    """Half-axis sample positions in (0, 1] (reference events_cmax.py:272-277)."""
    if log_scale:
        scale = np.logspace(0, 2.0, int(num_samples_per_param / 2.0) + 1)[1:]
        scale /= scale[-1]
    else:
        scale = np.linspace(0, 1.0, int(num_samples_per_param / 2.0) + 1)[1:]
    return scale


def _axes_from_ranges(param_ranges, scale):
    """Symmetric sample axes about each range's midpoint
    (reference events_cmax.py:285-292)."""
    axes = []
    for lo, hi in param_ranges:
        rng = hi - lo
        mid = lo + rng / 2.0
        pos = mid + scale * (rng / 2.0)
        neg = (mid - scale * (rng / 2.0))[::-1]
        axes.append(np.concatenate([neg, [mid], pos]))
    return axes


def grid_search_initial(xs, ys, ts, ps, warp_function, objective_function,
                        img_size, param_ranges=None, log_scale: bool = True,
                        num_samples_per_param: int = 5, device=None):
    """One level of SOFAS grid search (reference events_cmax.py:241-311).

    The ``num_samples^dims`` sample losses (blur 1.0) are queued on the
    device back to back and read once. Divergence kept from the JAX
    package: the true argmin is returned (the reference's ``best_eval = 0``
    start never selects a positive-loss optimum).
    """
    if num_samples_per_param % 2 != 1:
        raise ConfigurationError(
            f"num_samples_per_param must be odd, got {num_samples_per_param}")
    scale = _sample_scale(num_samples_per_param, log_scale)
    if param_ranges is None:
        param_ranges = [[-150, 150] for _ in range(warp_function.dims)]
    axes = _axes_from_ranges(param_ranges, scale)
    grids = np.meshgrid(*axes)
    coords = np.stack([g.ravel() for g in grids], axis=-1)  # (S, dims)

    dev, (dxs, dys, dts, dps) = _events(xs, ys, ts, ps, device)
    loss = make_objective_loss(objective_function, warp_function,
                               tuple(img_size), 1.0,
                               iwe_impl=DEFAULT_IWE_IMPL)
    cs = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    with torch.no_grad():
        evals = torch.stack([loss(c, dxs, dys, dts, dps) for c in cs])
    evals = to_numpy(evals).astype(np.float64)

    best = int(np.argmin(evals))
    return {
        "params": [tuple(c) for c in coords],
        "eval": list(evals),
        "search_axes": axes,
        "min_params": np.asarray(coords[best]),
        "min_func_eval": float(evals[best]),
    }


def find_new_range(search_axes, param):
    """New per-axis search range enclosing the unsearched region around the
    optimum (reference events_cmax.py:162-184; its asymmetric left-edge
    case replicated verbatim)."""
    search_axes = np.asarray(search_axes)
    nearest_idx = int(np.searchsorted(search_axes, param))
    if nearest_idx >= len(search_axes) - 1:
        d1 = abs(search_axes[-1] - search_axes[-2])
        d2 = d1
    elif nearest_idx == 0:
        d1 = abs(search_axes[0] - search_axes[-1])
        d2 = abs(search_axes[0] - search_axes[1])
    else:
        d1 = abs(search_axes[nearest_idx] - search_axes[nearest_idx - 1])
        d2 = abs(search_axes[nearest_idx] - search_axes[nearest_idx + 1])
    return [param - d1, param + d2]


def grid_search_optimisation(xs, ys, ts, ps, warp_function,
                             objective_function, img_size, param_ranges=None,
                             log_scale: bool = True,
                             num_samples_per_param: int = 5, depth: int = 0,
                             th0: float = 1, max_iters: int = 20,
                             device=None):
    """Recursive coarse-to-fine SOFAS search (reference
    events_cmax.py:186-237, with the intended recursion)."""
    if num_samples_per_param % 2 != 1 or num_samples_per_param < 5:
        raise ConfigurationError(
            "num_samples_per_param must be odd and >= 5, got "
            f"{num_samples_per_param}")
    dev, (xs, ys, ts, ps) = _events(xs, ys, ts, ps, device)
    optimal = grid_search_initial(xs, ys, ts, ps, warp_function,
                                  copy.deepcopy(objective_function), img_size,
                                  param_ranges=param_ranges,
                                  log_scale=log_scale,
                                  num_samples_per_param=num_samples_per_param)
    params = optimal["min_params"]
    new_ranges, max_range = [], 0.0
    for sa, param in zip(optimal["search_axes"], params):
        nr = find_new_range(sa, param)
        new_ranges.append(nr)
        max_range = max(max_range, abs(nr[1] - nr[0]))
    if max_range >= th0 and depth < max_iters:
        return grid_search_optimisation(
            xs, ys, ts, ps, warp_function, objective_function, img_size,
            param_ranges=new_ranges, log_scale=log_scale,
            num_samples_per_param=num_samples_per_param, depth=depth + 1,
            th0=th0, max_iters=max_iters)
    return optimal


# alias matching the (misspelled) reference call site (events_cmax.py:233,336)
recursive_search = grid_search_optimisation


def grid_search_refine(loss_fn: Callable, dims: int, init_range=150.0,
                       num_samples_per_param: int = 5,
                       log_scale: bool = False, iters: int = 8,
                       th0: float = 1.0, device=None):
    """Coarse-to-fine grid search with every step on the device.

    Each of ``iters`` levels samples ``num_samples^dims`` parameter vectors
    about the current best, evaluates ``loss_fn`` on each (the JAX
    package's ``vmap`` becomes a loop whose launches queue back to back),
    and re-centres each axis on the best sample with half the previous
    step. No value is read back inside the loop. Returns
    ``(best_params, best_eval)`` as tensors on ``device``.
    """
    del th0
    dev = pick_device(init_range, device=device)
    scale = torch.as_tensor(_sample_scale(num_samples_per_param, log_scale),
                            dtype=torch.float32, device=dev)

    def sample_axis(lo, hi):
        rng = hi - lo
        mid = lo + rng / 2.0
        pos = mid + scale * (rng / 2.0)
        neg = torch.flip(mid - scale * (rng / 2.0), dims=(0,))
        return torch.cat([neg, mid[None], pos])

    r0 = torch.as_tensor(init_range, dtype=torch.float32, device=dev)
    ranges = torch.stack([-r0, r0])[None, :].repeat(dims, 1)
    best_p = torch.zeros((dims,), dtype=torch.float32, device=dev)
    best_e = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for _ in range(iters):
            axes = torch.stack([sample_axis(ranges[d, 0], ranges[d, 1])
                                for d in range(dims)])  # (dims, S)
            mesh = torch.stack(torch.meshgrid(*[axes[d] for d in range(dims)],
                                              indexing="ij"), dim=-1)
            coords = mesh.reshape(-1, dims)
            evals = torch.stack([loss_fn(c) for c in coords])
            best = torch.argmin(evals)
            cand_p = coords[best]
            cand_e = evals[best]
            better = cand_e < best_e
            best_p = torch.where(better, cand_p, best_p)
            best_e = torch.where(better, cand_e, best_e)
            step = (axes[:, 1:] - axes[:, :-1]).max(dim=1).values
            ranges = torch.stack([cand_p - step, cand_p + step], dim=-1)
    return best_p, best_e
