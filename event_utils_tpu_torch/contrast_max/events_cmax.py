"""Contrast maximisation: gradient optimizers, grid search and the
ROI-tiled solvers (port of ``event_utils_tpu.contrast_max.events_cmax``).

Three paths, as in the JAX package:

* **Host-driven parity path** — ``optimize_contrast`` / ``optimize`` /
  ``optimize_r2`` keep the reference's scipy-BFGS driver semantics
  (reference events_cmax.py:313-389), including the per-iteration
  adaptive-lifespan callback. ``fprime`` is torch autograd through the
  scatter kernels. ``grid_cmax`` loops it over ROIs.
* **Whole-solve path** — ``optimize_contrast_jit`` runs the coarse-to-fine
  grid search and a BFGS (``contrast_max.bfgs``, a port of
  ``jax.scipy.optimize.minimize``) with every evaluation on the device.
* **ROI-bucketed path** — ``bucket_events_by_roi`` packs the events into
  (R, capacity) batches on the host; ``grid_cmax_batched`` solves every
  ROI at once, each evaluation one batched ``make_patch_loss`` (one launch
  of the CUDA bilinear kernel for all ROIs and grid samples), where JAX
  vmaps a per-ROI solver; its BFGS is one batched solve over the ROIs.
  ``fit_global_motion`` seeds its pyramid.

Where JAX vmaps a loss over parameter samples (the grid searches, the
landscape, the ROI solvers' full-frame loss), the port evaluates
``make_objective_loss`` at (S, dims) samples: the warps of all samples
splat in one launch of the batched bilinear kernel per chunk of
``batch_chunk`` samples.

Divergence from the JAX package: the scipy driver and the SOFAS grid search
form the IWE with the 'matmul' route (``DEFAULT_IWE_IMPL``), the
hand-written CUDA bilinear kernel on the card, as ``optimize_contrast_jit``
does by default. (The JAX host path used the exact XLA scatter; on the card
that would be ``index_add_``, which computes the same f32 sums.) On CPU
tensors 'matmul' is the kernel's plain f32 version.

``draw_objective_function`` samples its landscape on the device
(``_objective_landscape``) and only then imports matplotlib to plot it.
"""

from __future__ import annotations

import collections
import copy
import math
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.optimize as sciopt
import torch
import torch.nn.functional as F

from .. import native
from .._device import as_f32, as_tensor, pick_device, to_numpy
from ..errors import ConfigurationError
from ..models.objectives import (OBJECTIVE_REGISTRY, get_iwe,
                                 objective_function, soe_objective,
                                 variance_objective)
from ..models.warps import linvel_warp, warp_function, xyztheta_warp
from ..ops import cuda_scatter
from ..ops.blur import gaussian_filter, gaussian_kernel1d, zero_pad_blur
from ..ops.cuda_scatter import bilinear_patches_scatter
from ..utils import profiling
from ..utils.event_util import infer_resolution, lifespan_mask
from .bfgs import minimize_bfgs

DEFAULT_IWE_IMPL = "matmul"

# The counter of bytes the solvers copy from host arrays to the device
# (``utils.profiling``): on a CPU device, the same count.
H2D_BYTES = "cmax.h2d_bytes"

# What one chunk of a batched loss evaluation may hold: its samples' warped
# coordinates (S x N slots; 2 x 64 MB of f32 at the cap) and their images.
# A sample's images are counted as 4 planes of (H+1) x (W+1) f32: zhu's
# timestamp stack, or an IWE with its blur's copies. 400 landscape samples
# of 200k events take 5 chunks; a full-frame ROI solve at 640x480 takes
# ~200 rows a chunk, at 1280x720 ~70.
BATCH_MAX_SLOTS = 1 << 24
BATCH_MAX_IMAGE_BYTES = 1 << 30


def batch_chunk(n: int, img_size: Tuple[int, int]) -> int:
    """Samples of ``n`` events into ``img_size`` images that one chunk of a
    batched loss evaluation takes: within both ``BATCH_MAX_SLOTS`` and
    ``BATCH_MAX_IMAGE_BYTES``, at least one."""
    image_bytes = 16 * (img_size[0] + 1) * (img_size[1] + 1)
    return max(1, min(BATCH_MAX_SLOTS // max(n, 1),
                      BATCH_MAX_IMAGE_BYTES // image_bytes))


def make_objective_loss(objective: objective_function,
                        warpfunc: warp_function,
                        img_size: Tuple[int, int],
                        blur_sigma: Optional[float],
                        iwe_impl: Optional[str] = None) -> Callable:
    """Pure ``loss(params, xs, ys, ts, ps, mask)`` for an objective/warp
    pair (the autograd path). ``iwe_impl='matmul'`` forms the IWE with the
    CUDA bilinear kernel.

    ``params`` (dims,) gives the scalar loss; (S, dims) parameter samples
    give (S,) losses: JAX's ``jax.vmap(loss, in_axes=(0, None, ...))``
    (``_compiled_vmap_loss``) with the sample axis written out. The events
    and ``mask`` are then (N,), shared by the samples, or (S, N), a row per
    sample. (R, S, dims) params give (R, S) losses with (R, N) events, row
    r shared by its S samples (the ROI solvers' full-frame loss: a row per
    ROI). The warp gives (S, N) coordinates and one batched bilinear splat
    forms all S IWEs; each image is blurred over its own axes and reduced
    by ``torch.func.vmap`` of the objective's own reduction. The samples
    run in chunks of ``batch_chunk`` samples (with 'matmul', one CUDA
    launch each), which bounds the coordinates and images held at once; a
    row's samples stay in one chunk.

    Objectives that are not plain IWE reductions define ``make_event_loss``
    (zhu's timestamp-image loss, batched the same way) and get their true
    loss here. Objectives whose exact loss has zero gradient almost
    everywhere define ``soft_loss_fn`` (isoa's sigmoid surrogate), which is
    optimized here; report parity-exact values via
    ``objective.evaluate_function``.
    """
    if hasattr(objective, "make_event_loss"):
        one = objective.make_event_loss(warpfunc, img_size, blur_sigma,
                                        impl=iwe_impl)
    else:
        reduce_fn = getattr(objective, "soft_loss_fn", objective.loss_fn)

        def one(params, xs, ys, ts, ps, mask=None):
            iwe, _ = get_iwe(params, xs, ys, ts, ps, warpfunc, img_size,
                             use_polarity=objective.use_polarity, mask=mask,
                             impl=iwe_impl)
            if blur_sigma and blur_sigma > 0:
                iwe = gaussian_filter(iwe, blur_sigma, axes=(-2, -1))
            return (torch.func.vmap(reduce_fn) if iwe.dim() == 3
                    else reduce_fn)(iwe)

    def loss(params, xs, ys, ts, ps, mask=None):
        if np.ndim(params) < 2:
            return one(params, xs, ys, ts, ps, mask)
        lead = params.shape[:-1]
        reps = math.prod(lead[1:])
        step = max(1, batch_chunk(xs.shape[-1], img_size) // reps)
        flat = params.reshape(lead[0], reps, params.shape[-1])

        def rows(a, i):  # chunk i's event rows, one per sample
            if a is None or a.dim() < 2:
                return a
            a = a[i:i + step]
            return a if reps == 1 else a[:, None].expand(
                -1, reps, -1).reshape(-1, a.shape[-1])

        return torch.cat([one(flat[i:i + step].reshape(-1, flat.shape[-1]),
                              *(rows(a, i) for a in (xs, ys, ts, ps, mask)))
                          for i in range(0, lead[0], step)]).reshape(lead)

    return loss


def _upload(a, dev, dtype=None):
    """``as_tensor(a, dev, dtype)``; the bytes of a host array it copies to
    the device count under ``H2D_BYTES``."""
    t = as_tensor(a, dev, dtype)
    if not isinstance(a, torch.Tensor):
        profiling.count(H2D_BYTES, t.nbytes)
    return t


def _events(xs, ys, ts, ps, device):
    """The four event arrays as float32 tensors on one device."""
    dev = pick_device(xs, ys, ts, ps, device=device)
    return dev, tuple(_upload(a, dev, torch.float32) for a in (xs, ys, ts, ps))


def _value_and_grad(loss):
    """``value_and_grad`` for ``minimize_bfgs`` on the parameters' device:
    ``loss`` at (dims,) params or at (R, dims) rows, and its gradient by
    autograd. The rows are independent problems, so the gradient of the
    summed loss is each row's own."""

    def vg(p):
        p = p.detach().requires_grad_(True)
        f = loss(p)
        with profiling.span("cmax.grad"):
            (g,) = torch.autograd.grad(f.sum(), p)
        return f.detach(), g

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
    JAX's line search, ``maxiter`` and ``gtol=1e-6``, its state on the
    device. The grid search evaluates each level's samples as one batched
    loss, as JAX vmaps it. Returns the optimal parameters as a float32
    host tensor.
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
    res = minimize_bfgs(_value_and_grad(loss_p), as_f32(x0, dev),
                        maxiter=maxiter, gtol=1e-6)
    return res.x_k.cpu()


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

    The ``num_samples^dims`` sample losses (blur 1.0) are one batched
    evaluation of ``make_objective_loss`` (one batched splat launch per
    ``batch_chunk`` samples), as JAX vmaps them, and are read once.
    Divergence kept from the JAX package: the true argmin is returned (the
    reference's ``best_eval = 0`` start never selects a positive-loss
    optimum).
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
        evals = loss(cs, dxs, dys, dts, dps)
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
    about the current best, evaluates them all in one call of ``loss_fn``,
    which maps (S, dims) samples to (S,) losses (the JAX package's
    ``jax.vmap(loss_fn)`` with the sample axis written out, as a
    ``make_objective_loss`` loss does), and re-centres each axis on the best
    sample (the first of equal minima, as ``jnp.argmin``) with half the
    previous step. No value is read back inside the loop. Returns
    ``(best_params, best_eval)`` as tensors on ``device``.
    """
    del th0
    dev = pick_device(init_range, device=device)
    r0 = torch.as_tensor(init_range, dtype=torch.float32, device=dev)

    def batched_loss(coords):  # (1, S, dims) -> (1, S)
        return loss_fn(coords[0])[None]

    best_p, best_e = grid_search_refine_batched(
        batched_loss, dims, r0.reshape(1), num_samples_per_param, log_scale,
        iters)
    return best_p[0], best_e[0]


@profiling.spanned("cmax.grid_search")
def grid_search_refine_batched(loss_fn: Callable, dims: int, init_range,
                               num_samples_per_param: int = 5,
                               log_scale: bool = False, iters: int = 8):
    """``grid_search_refine`` for R independent problems at once (the JAX
    package's ``vmap`` over ROIs, ``events_cmax.py:423-468``).

    ``init_range`` is an (R,) tensor of per-problem half-ranges;
    ``loss_fn(coords)`` maps (R, S, dims) parameter samples to (R, S)
    losses in one evaluation. Returns ``(best_params (R, dims),
    best_eval (R,))``; nothing is read back to the host.
    """
    r0 = torch.as_tensor(init_range, dtype=torch.float32)
    dev = r0.device
    R = r0.shape[0]
    scale = _upload(_sample_scale(num_samples_per_param, log_scale), dev,
                    torch.float32)
    n_axis = 2 * scale.shape[0] + 1
    # meshgrid(indexing='ij') order of the samples, as (S, dims) indices
    grid_idx = np.stack(np.meshgrid(*[np.arange(n_axis)] * dims,
                                    indexing="ij"), -1).reshape(-1, dims)
    grid_idx = _upload(grid_idx, dev)
    dim_idx = torch.arange(dims, device=dev)[None, :]
    rows = torch.arange(R, device=dev)
    ranges = torch.stack([-r0, r0], -1)[:, None, :].expand(R, dims, 2)
    best_p = torch.zeros((R, dims), dtype=torch.float32, device=dev)
    best_e = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for _ in range(iters):
            lo, hi = ranges[..., 0:1], ranges[..., 1:2]
            rng = hi - lo
            mid = lo + rng / 2.0
            pos = mid + scale * (rng / 2.0)
            neg = torch.flip(mid - scale * (rng / 2.0), dims=(-1,))
            axes = torch.cat([neg, mid, pos], -1)            # (R, dims, n)
            coords = axes[:, dim_idx, grid_idx]              # (R, S, dims)
            evals = loss_fn(coords)
            best = torch.argmin(evals, dim=-1)
            cand_p = coords[rows, best]
            cand_e = evals[rows, best]
            better = cand_e < best_e
            best_p = torch.where(better[:, None], cand_p, best_p)
            best_e = torch.where(better, cand_e, best_e)
            step = (axes[..., 1:] - axes[..., :-1]).amax(-1)
            ranges = torch.stack([cand_p - step, cand_p + step], -1)
    return best_p, best_e


# ---------------------------------------------------------------------------
# ROI-tiled contrast maximisation (grid_cmax)
# ---------------------------------------------------------------------------

# Default ROI patch window: 20x20 ROIs centred with generous warp margins.
# Shared by make_patch_loss and the ROI solver's velocity cap so they can
# never desync.
PATCH_DEFAULT = (64, 128)

# pyramid='auto' selector threshold: an ROI whose plain-solve flow field is
# locally incoherent — 3x3-median deviation-from-neighbour-median above this
# fraction of the local flow magnitude — takes the pyramid field instead of
# its own answer. AUTO_MAG_FLOOR (px/s) keeps the normaliser away from zero
# in near-static regions. The values are the JAX package's (tuned there on
# its per-ROI oracle study, events_cmax.py:480-503).
AUTO_REL_COH_TAU = 0.2
AUTO_MAG_FLOOR = 5.0
# Scene-level escalation: when more than this fraction of valid ROIs is
# individually incoherent, 'auto' takes the whole pyramid field (with its
# median smoothing) instead of mixing per ROI.
AUTO_SCENE_FRAC = 0.5

# Hard memory bound on the overflow-refine tier's per-ROI capacity: beyond
# this, tier 2 itself subsamples (and grid_cmax_batched warns).
OVERFLOW_CAP_MAX = 1 << 17

PATCH_OBJECTIVES = ("variance", "sos", "rms", "soe", "sosa", "isoa", "moa",
                    "r1", "zhu")


# The device type on which make_patch_loss takes the fused kernel.
FUSED_DEVICE_TYPE = "cuda"
# The kernel routes (cuda_scatter's launch counters) of which one evaluation
# of make_patch_loss on the card launches one: the fused kernel's where
# fused_patch_variance says so, else one of the composed body's patch splat.
FUSED_PATCH_ROUTE = "patch_variance_vg"
PATCH_LOSS_ROUTES = (FUSED_PATCH_ROUTE, "bilinear_patches_scatter",
                     "bilinear_patches_scatter:direct")


def fused_patch_variance(objective, warpfunc, params_shape, device,
                         patch, blur_radius: int) -> bool:
    """Whether an evaluation of ``make_patch_loss`` at parameters of shape
    ``params_shape`` on ``device`` goes through the fused value-and-gradient
    kernel (``cuda_scatter.patch_variance_vg``): the variance objective and
    the linear-velocity warp (their classes), (R, 2) parameters with no
    sample axis, the card, and two patch planes with the blur's taps in a
    block's shared memory. Every other evaluation runs the composed body:
    the other objectives and warps, the grid searches' (R, S, dims)
    samples, the CPU."""
    return (type(objective) is variance_objective
            and type(warpfunc) is linvel_warp
            and len(params_shape) == 2 and params_shape[-1] == 2
            and torch.device(device).type == FUSED_DEVICE_TYPE
            and cuda_scatter.patch_variance_fits(*patch, blur_radius))


class _PatchVarianceVG(torch.autograd.Function):
    """``cuda_scatter.patch_variance_vg`` as a differentiable (R,) loss in
    ``params``: the forward launches the kernel once, with the gradient
    where ``with_grad`` (the caller's grad mode and ``params``'s
    ``requires_grad``) and keeps it; the backward scales it by the
    cotangent. Nothing is read back to the host, so a CUDA graph captures
    it."""

    @staticmethod
    def forward(ctx, params, ex, ey, et, ep, mask, origin_yx, taps, roi_size,
                patch, full_pixels, with_grad):
        out, grad = cuda_scatter.patch_variance_vg(
            ex, ey, et, ep, mask, origin_yx, params.contiguous(), taps,
            roi_size, patch, full_pixels, grad=with_grad)
        if with_grad:
            ctx.save_for_backward(grad)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (g[:, None] * grad,) + (None,) * 11


def make_patch_loss(warpfunc, roi_size, objective=None, patch=PATCH_DEFAULT,
                    blur_sigma: float = 1.0,
                    full_pixels: Optional[int] = None):
    """Per-ROI objective loss over patch-local IWEs, batched over ROIs and
    parameter samples (``make_patch_loss``, JAX ``events_cmax.py:506-662``).

    Each ROI's warped events are splatted bilinearly into a ``patch``
    window centred on the ROI; the full-frame loss is recovered
    analytically from patch sums (P = patch pixels, FP = full-frame pixels,
    pixels outside the patch hold 0):

      variance   -(Q/FP - (S/FP)^2)
      sos, rms   -Q/FP
      soe        -(sum exp(iwe) + (FP - P)) / FP
      sosa       -(sum exp(-p iwe) + (FP - P))
      r1         -(Q/FP) * (sum exp(-p iwe) + (FP - P))
      isoa       the objective's sigmoid surrogate ``soft_loss_fn``
      moa        -max(max iwe, 0)
      zhu        +(sum T_pos^2 + sum T_neg^2) over patch timestamp images

    Divergences kept from the JAX package: events warped beyond the patch
    are dropped, and the blur halo outside the patch is ignored.

    The accumulation differs in method, not in function: JAX forms each
    patch as a bf16 one-hot matmul ``A @ V``; here every patch of one
    evaluation goes through ONE launch of the CUDA patch kernel
    (``bilinear_patches_scatter``): the run of C slots of ROI r and sample
    s is splatted, in patch-local coordinates, into patch (r, s) only, and
    the kernel's autograd backward gives the gradient through the bilinear
    fractions. An event with a tap outside its patch has weight 0, as in
    JAX.

    Where ``fused_patch_variance`` says so (the variance objective under
    the linear-velocity warp at (R, 2) params on the card; the ROI refines
    and the ROI BFGS), and no event tensor requires grad, an evaluation is
    one launch of ``cuda_scatter.patch_variance_vg`` instead, which
    computes the same value and, when ``params`` requires grad, its
    gradient (``_PatchVarianceVG``).

    Returns ``loss(params, ex, ey, et, ep, mask, origin_yx)``. Events are
    (R, C) per-ROI batches with (R, 2) origins; ``params`` (R, dims) gives
    (R,) losses and (R, S, dims) gives (R, S). One ROI as 1-D (C,) events
    with (dims,) or (S, dims) params gives a scalar or (S,). Differentiable
    in ``params``. The blur taps go to a device once per loss and device,
    at the first evaluation there: no evaluation after it copies from the
    host, so a CUDA graph can capture it.
    """
    if objective is None or isinstance(objective, str):
        objective = OBJECTIVE_REGISTRY[objective or "variance"]()
    name = objective.name
    use_polarity = getattr(objective, "use_polarity", True)
    p_sup = float(getattr(objective, "p", 3))
    PH, PW = patch
    rh, rw = roi_size
    blur_k = (gaussian_kernel1d(blur_sigma)
              if blur_sigma and blur_sigma > 0 else None)
    FP = float(full_pixels if full_pixels is not None else PH * PW)
    Pp = float(PH * PW)
    # the blur taps on each device, uploaded at their first use (the fused
    # kernel blurs by one tap of 1 where the body does not blur)
    fused_k = blur_k if blur_k is not None else np.ones(1)
    taps = {}

    def taps_on(dev):
        k = taps.get(dev)
        if k is None:
            k = taps[dev] = _upload(fused_k, dev, torch.float32)
        return k

    def blur(img):
        if blur_k is None:
            return img
        return zero_pad_blur(img, taps_on(img.device))

    def loss(params, ex, ey, et, ep, mask, origin_yx):
        dev = ex.device
        single = ex.dim() == 1
        params = torch.as_tensor(params, dtype=torch.float32, device=dev)
        origin_yx = torch.as_tensor(origin_yx, dtype=torch.float32,
                                    device=dev)
        mask = torch.as_tensor(mask, device=dev).to(torch.float32)
        if single:
            ex, ey, et, ep, mask = (a[None] for a in (ex, ey, et, ep, mask))
            params, origin_yx = params[None], origin_yx[None]
        events = (ex, ey, et, ep, mask, origin_yx)
        if (fused_patch_variance(objective, warpfunc, params.shape, dev,
                                 patch, len(fused_k) // 2)
                and not any(a.requires_grad for a in events)):
            out = _PatchVarianceVG.apply(
                params, *(a.to(torch.float32).contiguous() for a in events),
                taps_on(dev), roi_size, patch, FP,
                torch.is_grad_enabled() and params.requires_grad)
            return out[0] if single else out
        no_samples = params.dim() == 2
        if no_samples:
            params = params[:, None]
        R, S, _ = params.shape
        on = mask != 0
        any_valid = on.any(-1)
        # empty ROIs (all-zero mask): pin t0 to 0 for a finite zero-IWE loss
        t0 = torch.where(any_valid,
                         torch.where(on, et, -torch.inf).amax(-1), 0.0)
        # warp_fn takes params[..., d, None]: each (R, S, 1) slice
        # broadcasts against the (R, 1, C) events
        xw, yw = warpfunc.warp_fn(params, ex[:, None], ey[:, None],
                                  et[:, None], t0[:, None, None])
        px = xw - (origin_yx[:, 1] + rw / 2.0 - PW / 2.0)[:, None, None]
        py = yw - (origin_yx[:, 0] + rh / 2.0 - PH / 2.0)[:, None, None]
        w_pol = ep if use_polarity else torch.abs(ep)
        w = (w_pol * mask)[:, None, :]
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        inpatch = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
        inw = inpatch.to(torch.float32)
        C = ex.shape[-1]
        fx = px.expand(R, S, C).reshape(-1).float()
        fy = py.expand(R, S, C).reshape(-1).float()

        def accumulate(wk):
            """(K, R, S, PH, PW) bilinear patches of the weights wk
            (K, R, 1 or S, C); events with a tap outside their patch get
            weight 0."""
            K = wk.shape[0]
            img = bilinear_patches_scatter(fx, fy, (wk * inw).reshape(K, -1),
                                           R * S, C, PH, PW)
            return img.view(K, R, S, PH, PW)

        if name == "zhu":
            t_first = torch.where(
                any_valid, torch.where(on, et, torch.inf).amin(-1), 0.0)
            nt = ((et - t_first[:, None])
                  / (t0 - t_first + 1e-6)[:, None])[:, None, :]
            posw = (ep > 0).to(torch.float32)[:, None, :] * mask[:, None, :]
            negw = (ep <= 0).to(torch.float32)[:, None, :] * mask[:, None, :]
            tpos, cpos, tneg, cneg = accumulate(torch.stack(
                [nt * posw, posw, nt * negw, negw]))
            pos = blur(tpos / (1.0 + cpos))
            neg = blur(tneg / (1.0 + cneg))
            out = (pos * pos).sum((-2, -1)) + (neg * neg).sum((-2, -1))
        else:
            iwe = blur(accumulate(w[None])[0])
            Q = (iwe * iwe).sum((-2, -1))
            if name in ("sos", "rms"):
                out = -Q / FP
            elif name == "soe":
                out = -(torch.exp(iwe).sum((-2, -1)) + (FP - Pp)) / FP
            elif name == "sosa":
                out = -(torch.exp(-p_sup * iwe).sum((-2, -1)) + (FP - Pp))
            elif name == "r1":
                sosa = torch.exp(-p_sup * iwe).sum((-2, -1)) + (FP - Pp)
                out = -(Q / FP) * sosa
            elif name == "isoa":
                # the objective's own surrogate, once per patch; the zero
                # pixels outside the patch add a params-independent constant
                out = torch.func.vmap(objective.soft_loss_fn)(
                    iwe.reshape(-1, PH, PW)).view(R, S)
            elif name == "moa":
                out = -torch.clamp(iwe.amax((-2, -1)), min=0.0)
            else:  # variance
                out = -(Q / FP - (iwe.sum((-2, -1)) / FP) ** 2)
        if no_samples:
            out = out[:, 0]
        return out[0] if single else out

    return loss


def make_patch_variance_loss(warpfunc, roi_size, patch=(64, 128),
                             blur_sigma: float = 1.0,
                             full_pixels: Optional[int] = None,
                             objective: str = "variance"):
    """Backward-compatible alias of :func:`make_patch_loss`."""
    return make_patch_loss(warpfunc, roi_size, objective, patch=patch,
                           blur_sigma=blur_sigma, full_pixels=full_pixels)


def grid_cmax(xs, ys, ts, ps, roi_size=(20, 20), step=None, warp=None,
              obj=None, min_events: int = 10, img_size=None, device=None):
    """Per-ROI contrast maximisation, host loop (reference
    events_cmax.py:28-76; JAX ``events_cmax.py:674-719``).

    Each ROI with more than ``min_events`` events runs two
    ``optimize_contrast`` stages (grid-search init with blur 2, then blur
    1) and reports its objective over the full-sensor IWE. As in the JAX
    package the passed ``warp``/``obj`` are honoured, and ``step`` is both
    the stride and the window extent (reference quirk). For throughput use
    :func:`grid_cmax_batched`. Returns ``(params, rois, f_evals)`` lists.
    """
    step = roi_size if step is None else step
    dev, (txs, tys, tts, tps) = _events(xs, ys, ts, ps, device)
    xs, ys, ts, ps = map(to_numpy, (txs, tys, tts, tps))
    resolution = infer_resolution(xs, ys) if img_size is None else img_size
    warp = linvel_warp() if warp is None else warp

    results_params, results_rois, results_f_evals = [], [], []
    for xc in range(0, resolution[1], step[1]):
        in_x = (xs >= xc) & (xs < xc + step[1])
        for yc in range(0, resolution[0], step[0]):
            sel = in_x & (ys >= yc) & (ys < yc + step[0])
            roi = tuple(a[sel] for a in (xs, ys, ts, ps))
            if len(roi[0]) > min_events:
                roi_obj = (variance_objective(adaptive_lifespan=True,
                                              minimum_events=105)
                           if obj is None else copy.deepcopy(obj))
                params = optimize_contrast(*roi, warp, roi_obj,
                                           numeric_grads=False,
                                           blur_sigma=2.0,
                                           img_size=resolution,
                                           grid_search_init=True, device=dev)
                params = optimize_contrast(*roi, warp, roi_obj,
                                           numeric_grads=False,
                                           blur_sigma=1.0,
                                           img_size=resolution, x0=params,
                                           device=dev)
                iwe, _ = get_iwe(params, txs, tys, tts, tps, warp,
                                 resolution, use_polarity=True,
                                 compute_gradient=False,
                                 impl=DEFAULT_IWE_IMPL)
                results_params.append(np.asarray(params))
                results_rois.append([yc, xc, step[0], step[1]])
                results_f_evals.append(roi_obj.evaluate_function(iwe=iwe))
    return results_params, results_rois, results_f_evals


def _roi_ids(xs, ys, resolution, roi_size):
    """Row-major ROI id of every event (coordinates clipped to the grid)
    and the grid's (ny, nx)."""
    H, W = resolution
    rh, rw = roi_size
    ny = (H + rh - 1) // rh
    nx = (W + rw - 1) // rw
    rid = (np.clip(ys.astype(np.int64) // rh, 0, ny - 1) * nx
           + np.clip(xs.astype(np.int64) // rw, 0, nx - 1))
    return rid, ny, nx


@profiling.spanned("cmax.bucket")
def bucket_events_by_roi(xs, ys, ts, ps, resolution, roi_size,
                         capacity: Optional[int] = None,
                         capacity_cap: Optional[int] = 2048,
                         rng: Optional[np.random.Generator] = None,
                         return_counts: bool = False, device=None):
    """Bucket events into fixed-capacity per-ROI batches on the host (JAX
    ``events_cmax.py:722-814``).

    Returns ``(bx, by, bt, bp, bmask, roi_origins, overflow)``: each ``b*``
    an (R, capacity) float32 tensor on ``device`` (default: the inputs'
    device, else the card), ``roi_origins`` (R, 2) = (y0, x0), and
    ``overflow`` the number of events subsampled away. Time order is kept
    within each ROI. ROIs holding more than ``capacity`` events are
    uniformly subsampled with ``rng.choice`` (``np.random.default_rng(0)``
    unless ``rng`` is given), the same draws as the JAX package. Default
    capacity: the max ROI count rounded up to a power of two, clipped to
    ``capacity_cap``. ``return_counts=True`` appends the true per-ROI
    counts (numpy, (R,)).

    When no ROI overflows, the native runtime's counting-sort
    ``native.bucket_fill`` fills the batches in one O(n) pass (JAX
    ``events_cmax.py:756-771``); the same arrays as the numpy fill.
    """
    dev = pick_device(xs, ys, ts, ps, device=device)
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    rid, ny, nx = _roi_ids(xs, ys, resolution, roi_size)
    R = ny * nx
    counts = np.bincount(rid, minlength=R)
    if capacity is None:
        capacity = int(counts.max()) if len(counts) else 1
        capacity = max(1, int(2 ** np.ceil(np.log2(max(capacity, 1)))))
        if capacity_cap is not None:
            capacity = min(capacity, capacity_cap)
    if counts.max(initial=0) <= capacity:
        *packed, _ = native.bucket_fill(xs, ys, ts, ps, roi_size, (ny, nx),
                                        capacity)
        oy, ox = np.divmod(np.arange(R), nx)
        origins = np.stack([oy * roi_size[0], ox * roi_size[1]], axis=-1)
        # torch.tensor copies: the fill's buffers rotate
        out = tuple(torch.tensor(a, device=dev) for a in packed) + (
            torch.tensor(origins, dtype=torch.int64, device=dev), 0)
        profiling.count(H2D_BYTES, sum(t.nbytes for t in out[:-1]))
        return out + (counts,) if return_counts else out
    # every ROI, in row-major order: the same fill and the same draws
    *packed, origins, overflow = _pack_roi_subset(
        xs, ys, ts, ps, resolution, roi_size, np.arange(R), capacity, R,
        rng=rng, device=dev)
    out = (*packed, origins.to(torch.int64), overflow)
    return out + (counts,) if return_counts else out


def _tier2_shapes(max_count: int, n_over: int):
    """Power-of-two batch shape of the overflow-refine tier (JAX
    ``events_cmax.py:822-847``, which rounds to keep one compiled
    executable across drifting windows; kept here so that both packages
    solve the same padded batch). Returns ``(cap2, R2)``: per-ROI capacity
    (a power-of-two multiple of 512, clamped to ``OVERFLOW_CAP_MAX``) and
    the padded row count (a power of two, min 8)."""
    cap2 = 512
    while cap2 < max_count:
        cap2 <<= 1
    cap2 = min(cap2, OVERFLOW_CAP_MAX)
    R2 = 8
    while R2 < n_over:
        R2 <<= 1
    return cap2, R2


@profiling.spanned("cmax.bucket")
def _pack_roi_subset(xs, ys, ts, ps, resolution, roi_size, roi_ids,
                     capacity, total_rows,
                     rng: Optional[np.random.Generator] = None, device=None):
    """Pack the events of the given ROI ids into a fixed
    ``(total_rows, capacity)`` batch (rows beyond ``len(roi_ids)`` are
    zero-mask padding): the overflow-refine tier of ``grid_cmax_batched``
    (JAX ``events_cmax.py:850-914``). ROIs still above ``capacity`` are
    uniformly subsampled; ``overflow`` counts those events. Returns
    ``(bx, by, bt, bp, bmask, origins, overflow)`` as tensors on
    ``device``.
    """
    dev = pick_device(xs, ys, ts, ps, device=device)
    rh, rw = roi_size
    roi_ids = np.asarray(roi_ids, np.int64)
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    rid, ny, nx = _roi_ids(xs, ys, resolution, roi_size)
    local = np.full(ny * nx, -1, np.int64)
    local[roi_ids] = np.arange(len(roi_ids))
    keep = np.nonzero(local[rid] >= 0)[0]
    loc = local[rid[keep]]
    sort = np.argsort(loc, kind="stable")  # time order preserved per ROI
    order, loc = keep[sort], loc[sort]
    counts = np.bincount(loc, minlength=len(roi_ids))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    overflow = int(np.maximum(counts - capacity, 0).sum())
    if overflow:
        rng = np.random.default_rng(0) if rng is None else rng
        sel = []
        for r in range(len(roi_ids)):
            src = order[starts[r]:starts[r] + counts[r]]
            if len(src) > capacity:
                src = src[np.sort(rng.choice(len(src), capacity,
                                             replace=False))]
            sel.append(src)
        order = (np.concatenate(sel) if sel
                 else np.empty(0, order.dtype))
        counts = np.minimum(counts, capacity)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        loc = np.repeat(np.arange(len(roi_ids)), counts)
    flat = loc * capacity + (np.arange(len(order)) - starts[loc])

    def pack(arr):
        out = np.zeros(total_rows * capacity, dtype=np.float32)
        out[flat] = arr[order]
        return _upload(out.reshape(total_rows, capacity), dev)

    bmask = np.zeros(total_rows * capacity, np.float32)
    bmask[flat] = 1.0
    oy, ox = np.divmod(roi_ids, nx)
    origins = np.zeros((total_rows, 2), np.float32)
    origins[:len(roi_ids), 0] = oy * rh
    origins[:len(roi_ids), 1] = ox * rw
    return (pack(xs), pack(ys), pack(ts), pack(ps),
            _upload(bmask.reshape(total_rows, capacity), dev),
            _upload(origins, dev), overflow)


@profiling.spanned("cmax.descent")
def _normalized_descent(f, x0, maxiter: int, gd_lr: float, clamp=None):
    """Fixed-``maxiter`` normalised-gradient descent with momentum 0.8,
    cosine learning rate and best-iterate tracking, batched over rows.

    ``f`` maps (R, dims) parameters to (R,) losses; rows are independent,
    so the gradient of ``f(p).sum()`` is each row's own gradient.
    ``clamp(p)`` (optional) projects every iterate. Nothing is read back to
    the host inside the loop. Returns ``(best_p, best_v)``.
    """
    def value_and_grad(p):
        with torch.enable_grad():
            p = p.detach().requires_grad_(True)
            v = f(p)
            with profiling.span("cmax.grad"):
                (g,) = torch.autograd.grad(v.sum(), p)
        return v.detach(), g

    with torch.no_grad():
        p = x0
        m = torch.zeros_like(x0)
        best_p, best_v = x0, f(x0)
        for i in range(maxiter):
            v, g = value_and_grad(p)
            better = v < best_v
            best_p = torch.where(better[:, None], p, best_p)
            best_v = torch.where(better, v, best_v)
            g = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                     + 1e-12)
            m = 0.8 * m + g
            lr = gd_lr * 0.5 * (1 + math.cos(math.pi * i / maxiter))
            p = p - lr * m
            if clamp is not None:
                p = clamp(p)
        v_final = f(p)
        final_better = v_final < best_v
        best_p = torch.where(final_better[:, None], p, best_p)
        best_v = torch.where(final_better, v_final, best_v)
    return best_p, best_v


def fit_global_motion(xs, ys, ts, ps, img_size, obj=None,
                      blur_sigma: float = 1.0, maxiter: int = 80,
                      gd_lr: float = 4.0, mask=None, device=None):
    """Full-frame 4-DoF global motion fit under the ``xyztheta`` field
    ``v(x, y) = (vx + s*x - w*y, vy + s*y + w*x)`` (JAX
    ``events_cmax.py:920-1001``).

    A 2-D grid search over pure translation, then normalised-gradient
    descent over all four dims in a scaled space where one unit of s or w
    moves a point half a sensor diagonal away by ~1 px/s, with the scale
    change capped at |s|*dt <= 0.4 and the rotation at |w|*dt <= 1 rad over
    the window. Each loss forms its IWE with the CUDA bilinear kernel
    (``iwe_impl='matmul'``; the JAX package uses its exact scatter, the
    same f32 sums). Returns ``(params (4,), loss)`` as tensors.
    """
    obj = variance_objective() if obj is None else obj
    resolution = tuple(int(v) for v in img_size)
    dev, (exs, eys, ets, eps) = _events(xs, ys, ts, ps, device)
    emask = (torch.ones_like(eps) if mask is None else as_f32(mask, dev))
    loss = make_objective_loss(obj, xyztheta_warp(), resolution, blur_sigma,
                               iwe_impl=DEFAULT_IWE_IMPL)
    r0 = 0.5 * float(np.hypot(*resolution))
    scale = _upload(np.array([1.0, 1.0, 1.0 / r0, 1.0 / r0]), dev,
                    torch.float32)
    zeros2 = torch.zeros(2, device=dev)

    def f_q(q):
        return loss(q * scale, exs, eys, ets, eps, emask)

    on = emask != 0
    t_hi = torch.where(on, ets, -torch.inf).max()
    t_lo = torch.where(on, ets, torch.inf).min()
    dt_w = torch.where(on.any(), torch.clamp(t_hi - t_lo, min=1e-3), 1.0)
    inf = torch.tensor(torch.inf, device=dev)
    qmax = torch.stack([inf, inf, 0.4 / dt_w * r0, 1.0 / dt_w * r0])

    q0_t, _ = grid_search_refine(
        lambda V: f_q(torch.cat([V, zeros2.expand(V.shape[0], 2)], -1)), 2,
        init_range=150.0, num_samples_per_param=5, iters=6, device=dev)
    q0 = torch.cat([q0_t, zeros2])[None]
    best_q, best_v = _normalized_descent(
        lambda q: f_q(q[0])[None], q0, maxiter, gd_lr,
        clamp=lambda q: torch.minimum(torch.maximum(q, -qmax), qmax))
    return best_q[0] * scale, best_v[0]


def xyztheta_velocity_at(params, x, y):
    """The velocity field of ``xyztheta`` params at points (x, y):
    ``(vx + s*x - w*y, vy + s*y + w*x)`` — e.g. to seed per-ROI linvel
    solves from a global fit. Host numpy."""
    vx, vy, s, w = (float(v) for v in to_numpy(params)[:4])
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    return np.stack([vx + s * x - w * y, vy + s * y + w * x], axis=-1)


def _neighbor_median(params, valid, ny, nx):
    """Per-ROI 3x3 neighbour median of valid params over the (ny, nx) ROI
    grid (row-major), NaN-ignoring, with ``jnp.nanmedian``'s midpoint rule
    (the mean of the two middle values for an even count); ROIs with no
    valid neighbour keep their own params."""
    d = params.shape[-1]
    grid = torch.where(valid[:, None], params, torch.nan).reshape(ny, nx, d)
    padded = F.pad(grid.permute(2, 0, 1), (1, 1, 1, 1),
                   value=torch.nan).permute(1, 2, 0)
    stack = torch.stack([padded[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    srt = torch.sort(stack, dim=0).values          # NaN sorts last
    count = (~torch.isnan(stack)).sum(0)
    q = 0.5 * (count - 1).to(params.dtype)
    lo = torch.clamp(torch.floor(q), min=0).long()
    lo = torch.minimum(lo, torch.clamp(count - 1, min=0))
    hi = torch.minimum(torch.clamp(torch.ceil(q), min=0).long(),
                       torch.clamp(count - 1, min=0))
    med = (torch.gather(srt, 0, lo[None])[0]
           + torch.gather(srt, 0, hi[None])[0]) * 0.5
    med = med.reshape(ny * nx, d)
    return torch.where(torch.isnan(med), params, med)


@profiling.spanned("cmax.solve")
def grid_cmax_batched(xs, ys, ts, ps, roi_size=(20, 20), warp=None,
                      obj=None, min_events: int = 10, img_size=None,
                      blur_sigma: float = 1.0, maxiter: int = 50,
                      capacity: Optional[int] = None,
                      solver: str = "gd", gd_lr: float = 4.0,
                      smooth: Optional[str] = None, x0=None,
                      pyramid=1, trust_radius: Optional[float] = None,
                      overflow_refine: bool = True, device=None):
    """All-ROIs-at-once contrast maximisation (JAX
    ``events_cmax.py:1015-1317``).

    Events are bucketed by ROI into fixed-capacity batches (subsampled
    above the capacity cap); a velocity-capped coarse-to-fine grid search,
    the adaptive-lifespan mask and a fixed-step refine run for every ROI at
    once, each loss evaluation one batched patch loss for all ROIs and
    samples: one launch of ``patch_variance_vg`` for the variance
    objective's warm refine on the card (``fused_patch_variance``), else one
    patch splat (``PATCH_LOSS_ROUTES``).

    Options, as in JAX:

    - ``x0`` (R, dims): warm start; skips the grid search (and any
      pyramid), descends from ``x0`` with per-ROI trust radius
      ``trust_radius`` (None: unconstrained).
    - ``smooth='median'``: 3x3 neighbour-median of the final field.
    - ``pyramid=k`` (linvel only): solve at ``roi_size * 2^(k-1)`` first
      (the base seeded by ``fit_global_motion``), median-smooth, and refine
      each finer level from its parent ROI inside an adaptive trust ball.
    - ``pyramid='auto'``: both the plain and the pyramid-2+median fields,
      selected per ROI by the local coherence of the plain field, with
      scene-level escalation (``AUTO_*``).
    - ``overflow_refine``: ROIs above capacity are re-solved on their full
      event sets in a second, power-of-two-sized batch, warm-started from
      tier 1.
    - ``solver``: ``'gd'`` (normalised-gradient descent) or ``'bfgs'``
      (the port's BFGS, one batched solve over all ROIs).

    Returns ``(params (R, dims), rois (R, 4), f_evals (R,), valid (R,))``
    as tensors on ``device`` (default: the inputs' device, else the card).
    """
    warp = linvel_warp() if warp is None else warp
    obj = variance_objective() if obj is None else obj
    dev = pick_device(xs, ys, ts, ps, x0, device=device)
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    resolution = infer_resolution(xs, ys) if img_size is None else img_size
    resolution = tuple(int(v) for v in resolution)
    rh, rw = roi_size
    ny = (resolution[0] + rh - 1) // rh
    nx = (resolution[1] + rw - 1) // rw
    common = dict(roi_size=roi_size, warp=warp, obj=obj,
                  min_events=min_events, img_size=resolution,
                  blur_sigma=blur_sigma, maxiter=maxiter, capacity=capacity,
                  solver=solver, gd_lr=gd_lr,
                  overflow_refine=overflow_refine, device=dev)

    if pyramid == "auto":
        if x0 is not None or not isinstance(warp, linvel_warp):
            pyramid = 1  # warm start / non-linvel: the cascade is suppressed
        else:
            p_plain, rois, f_plain, valid = grid_cmax_batched(
                xs, ys, ts, ps, trust_radius=trust_radius, **common)
            p_pyr, _, f_pyr, _ = grid_cmax_batched(
                xs, ys, ts, ps, pyramid=2, smooth="median",
                trust_radius=trust_radius, **common)
            med = _neighbor_median(p_plain, valid, ny, nx)
            dev_ = torch.linalg.vector_norm(p_plain - med, dim=-1)
            coh = _neighbor_median(dev_[:, None], valid, ny, nx)[:, 0]
            mag = torch.linalg.vector_norm(p_plain, dim=-1)
            lmag = _neighbor_median(mag[:, None], valid, ny, nx)[:, 0]
            sel = coh > AUTO_REL_COH_TAU * torch.clamp(lmag,
                                                       min=AUTO_MAG_FLOOR)
            nvalid = torch.clamp(valid.sum(), min=1)
            global_pyr = (sel & valid).sum() > AUTO_SCENE_FRAC * nvalid
            sel = sel | global_pyr
            params = torch.where(sel[:, None], p_pyr, p_plain)
            f_evals = torch.where(sel, f_pyr, f_plain)
            if smooth is not None:
                if smooth != "median":
                    raise ConfigurationError(f"unknown smooth mode "
                                             f"{smooth!r}")
                params = _neighbor_median(params, valid, ny, nx)
            return params, rois, f_evals, valid

    trust_vec = None  # per-ROI L-inf trust radii for the warm refine
    if pyramid > 1 and x0 is None and isinstance(warp, linvel_warp):
        coarse_kw = {}
        if pyramid == 2:
            # recursion base: a full-frame 4-DoF fit seeds each coarse ROI
            # with the induced velocity at its centre
            g_params, _ = fit_global_motion(xs, ys, ts, ps, resolution,
                                            obj=obj, blur_sigma=blur_sigma,
                                            device=dev)
            g_params = to_numpy(g_params)
            nyc2 = (resolution[0] + 2 * rh - 1) // (2 * rh)
            nxc2 = (resolution[1] + 2 * rw - 1) // (2 * rw)
            oy2, ox2 = np.divmod(np.arange(nyc2 * nxc2), nxc2)
            coarse_kw["x0"] = _upload(xyztheta_velocity_at(
                g_params, ox2 * 2 * rw + rw, oy2 * 2 * rh + rh), dev)
            coarse_kw["trust_radius"] = 3.0 + float(np.hypot(rh, rw)) * float(
                np.hypot(g_params[2], g_params[3]))
        kw = dict(common, roi_size=(rh * 2, rw * 2))
        c_params = to_numpy(grid_cmax_batched(
            xs, ys, ts, ps, smooth="median", pyramid=pyramid - 1,
            **coarse_kw, **kw)[0])
        nyc = (resolution[0] + 2 * rh - 1) // (2 * rh)
        nxc = (resolution[1] + 2 * rw - 1) // (2 * rw)
        iy, ix = np.divmod(np.arange(ny * nx), nx)
        parent = (np.minimum(iy // 2, nyc - 1) * nxc
                  + np.minimum(ix // 2, nxc - 1))
        x0 = _upload(c_params[parent], dev)
        if trust_radius is None:
            # adaptive trust: floor + a quarter of the 3x3 coarse spread
            cgrid = c_params.reshape(nyc, nxc, -1)
            pad = np.pad(cgrid, ((1, 1), (1, 1), (0, 0)), mode="edge")
            neigh = np.stack([pad[1 + dy:1 + dy + nyc, 1 + dx:1 + dx + nxc]
                              for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
            spread = (neigh.max(axis=0) - neigh.min(axis=0)).max(axis=-1)
            trust_c = 3.0 + 0.25 * spread.reshape(-1)
            trust_vec = _upload(trust_c[parent], dev, torch.float32)
        else:
            trust_vec = torch.full((ny * nx,), float(trust_radius),
                                   device=dev)

    bx, by, bt, bp, bmask, origins, overflow, counts = bucket_events_by_roi(
        xs, ys, ts, ps, resolution, roi_size, capacity, return_counts=True,
        device=dev)
    origins_f = origins.to(torch.float32)
    args = (warp, obj, resolution, roi_size, blur_sigma, maxiter, solver,
            gd_lr)
    if x0 is not None:
        if trust_vec is None:
            trust_vec = torch.full((origins.shape[0],),
                                   torch.inf if trust_radius is None
                                   else float(trust_radius), device=dev)
        params, f_evals = _warm_roi_solver(*args)(
            bx, by, bt, bp, bmask, origins_f, _upload(x0, dev, torch.float32),
            trust_vec)
    else:
        params, f_evals = make_roi_solve_one(*args)(bx, by, bt, bp, bmask,
                                                    origins_f)
    valid = bmask.sum(1) > min_events

    if overflow and overflow_refine:
        # tier 2: re-solve the over-capacity ROIs on their full event sets,
        # warm-started from tier 1 (or replaying tier 1's own warm start)
        cap_used = int(bx.shape[1])
        over = np.nonzero(counts > cap_used)[0]
        cap2, R2 = _tier2_shapes(int(counts[over].max()), len(over))
        if cap2 >= cap_used:
            bx2, by2, bt2, bp2, bm2, org2, overflow = _pack_roi_subset(
                xs, ys, ts, ps, resolution, roi_size, over, cap2, R2,
                device=dev)
            dims = params.shape[-1]
            x0_2 = torch.zeros((R2, dims), device=dev)
            trust2 = torch.full((R2,), torch.inf, device=dev)
            over_t = _upload(over, dev)
            if x0 is not None:
                x0_2[:len(over)] = _upload(x0, dev, torch.float32)[over_t]
                trust2[:len(over)] = trust_vec[over_t]
            else:
                x0_2[:len(over)] = params[over_t]
            p2, f2 = _warm_roi_solver(*args)(bx2, by2, bt2, bp2, bm2, org2,
                                             x0_2, trust2)
            params = params.clone()
            f_evals = f_evals.clone()
            params[over_t] = p2[:len(over)]
            f_evals[over_t] = f2[:len(over)]

    if smooth is not None:
        if smooth != "median":
            raise ConfigurationError(f"unknown smooth mode {smooth!r}")
        params = _neighbor_median(params, valid, ny, nx)

    size = _upload(np.array([[rh, rw]]), dev, origins.dtype)
    rois = torch.cat([origins, size.expand(origins.shape[0], 2)], dim=-1)
    if overflow:
        import warnings

        warnings.warn(
            f"grid_cmax_batched: {overflow} events beyond the per-ROI "
            f"capacity were uniformly subsampled"
            + (" in the overflow-refine tier (an ROI holds more than "
               f"OVERFLOW_CAP_MAX={OVERFLOW_CAP_MAX} events)"
               if overflow_refine else
               " (raise capacity= or leave overflow_refine on to keep "
               "them)"), RuntimeWarning, stacklevel=2)
    return params, rois, f_evals, valid


def _warm_roi_solver(warp, obj, resolution, roi_size, blur_sigma, maxiter,
                     solver, gd_lr):
    """The warm-start refine solver (``with_x0`` and a per-ROI trust radius),
    shared by the temporal/pyramid warm path and the tier-2 refine. (JAX
    compiles and caches its solvers per configuration; building one here
    only makes closures. On the card its GD refine is replayed from a CUDA
    graph kept by key, ``RefineGraphs``, from the second solve of a key.)"""
    return make_roi_solve_one(warp, obj, tuple(resolution), roi_size,
                              blur_sigma, maxiter, solver, gd_lr,
                              with_x0=True, trust_radius="traced")


def _roi_patch(roi_size):
    """The patch window of a ROI solve: it encloses the ROI with warp
    margin."""
    return (max(PATCH_DEFAULT[0], -(-(roi_size[0] + 32) // 8) * 8),
            max(PATCH_DEFAULT[1], -(-(roi_size[1] + 32) // 128) * 128))


def _roi_patch_loss(warp, obj, resolution, roi_size, blur_sigma):
    """The batched patch loss ``(p, ex, ey, et, ep, emask, origin) -> (R,)``
    that ``make_roi_solve_one`` minimises for a patch objective."""
    return make_patch_loss(warp, roi_size, obj, patch=_roi_patch(roi_size),
                           blur_sigma=blur_sigma,
                           full_pixels=(resolution[0] + 1)
                           * (resolution[1] + 1))


# Counters (``utils.profiling``) of the refine's CUDA graphs.
GRAPH_CAPTURES = "cmax.graph_captures"
GRAPH_REPLAYS = "cmax.graph_replays"
# Refine graphs kept (the least recently used beyond it go, with their
# memory pools), and keys remembered as seen once.
REFINE_GRAPHS_KEPT = 8
KEYS_SEEN_KEPT = 256


class _CudaGraphs:
    """Capture and replay with ``torch.cuda.CUDAGraph``, on the card that
    holds the tensors."""

    @staticmethod
    def engages(device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def warm_up(device, run):
        """``run`` once, eagerly, on a side stream (PyTorch's rule before a
        capture)."""
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)

    @staticmethod
    def capture(device, run):
        """``(graph, run's outputs)``: the outputs live in the graph's
        memory pool and each replay writes them anew."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph):
            out = run()
        return graph, out

    @staticmethod
    def replay(device, graph):
        with torch.cuda.device(device):
            graph.replay()


class _RefineGraph:
    """One captured refine: its static inputs and outputs, the graph, the
    launches it makes (route: count) and the body, kept alive with what the
    graph reads (the loss's blur taps)."""

    __slots__ = ("inputs", "outputs", "graph", "launches", "body")


class RefineGraphs:
    """The GD refine of the ROI solvers, run eagerly or replayed from a
    CUDA graph, by key.

    ``run(key, inputs, body)`` returns ``body(*inputs)``, a tuple of
    tensors. Where the backend engages for the inputs' device (the card)
    and ``key`` was seen before in this process, the body is captured once
    (after a warm-up) over static copies of ``inputs``, and every later call
    with that key copies its inputs into them, replays the graph and
    returns copies of its outputs. The key must hold every value the
    captured work depends on besides the inputs' contents. A call that
    meets a key the first time runs eagerly, so one-off shapes never pay a
    capture. A failed capture raises.

    A replay adds the launches the capture counted to
    ``cuda_scatter.launch_counts()`` (the capture itself launched nothing,
    so its count is taken back), and counts ``GRAPH_CAPTURES`` and
    ``GRAPH_REPLAYS``. The engaged path is the span ``cmax.descent``.
    """

    def __init__(self, backend=_CudaGraphs):
        self.backend = backend
        self.seen = collections.OrderedDict()
        self.entries = collections.OrderedDict()
        self.lock = threading.Lock()

    def run(self, key, inputs, body):
        device = inputs[0].device
        if not self.backend.engages(device):
            return body(*inputs)
        with self.lock:
            entry = self.entries.get(key)
            if entry is None and self.seen.pop(key, None) is None:
                self.seen[key] = True
                while len(self.seen) > KEYS_SEEN_KEPT:
                    self.seen.popitem(last=False)
                return body(*inputs)
            with profiling.span("cmax.descent"):
                if entry is None:
                    entry = self._capture(key, inputs, body)
                self.entries.move_to_end(key)
                for static, a in zip(entry.inputs, inputs):
                    static.copy_(a)
                self.backend.replay(device, entry.graph)
                cuda_scatter.add_launch_counts(entry.launches)
                profiling.count(GRAPH_REPLAYS)
                return tuple(o.clone() for o in entry.outputs)

    def _capture(self, key, inputs, body):
        device = inputs[0].device
        entry = _RefineGraph()
        entry.inputs = tuple(a.clone() for a in inputs)
        entry.body = body
        self.backend.warm_up(device, lambda: body(*entry.inputs))
        before = cuda_scatter.launch_counts()
        entry.graph, entry.outputs = self.backend.capture(
            device, lambda: body(*entry.inputs))
        after = cuda_scatter.launch_counts()
        entry.launches = {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}
        cuda_scatter.add_launch_counts(
            {k: -n for k, n in entry.launches.items()})
        profiling.count(GRAPH_CAPTURES)
        self.entries[key] = entry
        while len(self.entries) > REFINE_GRAPHS_KEPT:
            self.entries.popitem(last=False)
        return entry


# The process's refine graphs (``make_roi_solve_one``'s GD refine).
_REFINE_GRAPHS = RefineGraphs()


def _settings(o):
    """An objective's or a warp's class and scalar attributes: what its
    part of a captured loss depends on."""
    return type(o), tuple(sorted(
        (k, v) for k, v in getattr(o, "__dict__", {}).items()
        if isinstance(v, (bool, int, float, str, type(None)))))


def make_roi_solve_one(warp, obj, resolution, roi_size, blur_sigma, maxiter,
                       solver="gd", gd_lr=4.0, with_x0: bool = False,
                       trust_radius=None):
    """Batched ROI solve ``(ex, ey, et, ep, emask, origin) -> (params,
    f_eval)`` over (R, C) event batches and (R, 2) origins (JAX
    ``make_roi_solve_one``, ``events_cmax.py:1363-1511``, whose per-ROI
    function JAX vmaps): patch loss (every objective), velocity-capped grid
    search, adaptive-lifespan mask, fixed-step refine.

    ``with_x0=True`` returns the refine variant ``(..., origin, x0)`` that
    skips the grid search and descends from ``x0`` (R, dims).
    ``trust_radius`` clamps the iterate to an L-inf ball of that radius
    around ``x0``; the string ``'traced'`` takes a per-ROI radius as one
    more trailing argument ``trust`` (R,).

    ``solver='gd'``: fixed-``maxiter`` normalised-gradient descent, every
    ROI in each batched step. With a patch objective on the card it runs
    through ``RefineGraphs``: eagerly the first time its key (device,
    shapes, objective, warp, sizes, ``maxiter``, ``gd_lr``, whether a trust
    clamp applies) is met in the process, captured as a CUDA graph the
    second time and replayed from then on; the same body either way.
    ``solver='bfgs'``: the port's BFGS
    (``contrast_max.bfgs``, a port of ``jax.scipy.optimize.minimize``), one
    batched solve over the R ROIs, each row walking its own path as under
    JAX's vmap.

    Objectives outside ``PATCH_OBJECTIVES`` use the full-frame loss
    (``make_objective_loss``), one batched evaluation over a row per ROI
    (and per grid sample), each row the ROI's events.
    """
    if solver not in ("gd", "bfgs"):
        raise ConfigurationError(f"unknown solver {solver!r}")
    use_patch = obj.name in PATCH_OBJECTIVES
    patch = _roi_patch(roi_size)
    if use_patch:
        patch_loss = _roi_patch_loss(warp, obj, resolution, roi_size,
                                     blur_sigma)
    else:  # custom objectives: the full-frame loss, a row per ROI (sample)
        full_loss = make_objective_loss(obj, warp, resolution, blur_sigma,
                                        iwe_impl=DEFAULT_IWE_IMPL)

    adaptive = getattr(obj, "adaptive_lifespan", False)
    pixel_crossings = getattr(obj, "pixel_crossings", 5)
    min_events = getattr(obj, "minimum_events", 105)
    # velocity search cap: never search params that empty the patch within
    # the ROI's window (a spurious minimum for mass-losing objectives)
    margin = (min(patch[0] - roi_size[0],
                  patch[1] - roi_size[1]) / 2.0 - 2.0)
    velocity_cap = (use_patch and isinstance(warp, linvel_warp)
                    and margin > 2.0)

    def _losses(ex, ey, et, ep, emask, origin):
        """(f_masked, f) for a batch of ROIs: ``f_masked(p, m)`` at (R,
        dims) or (R, S, dims) params, ``f(p)`` with the full masks — the
        one definition of the patch-vs-full loss shared by the cold and warm
        solvers."""
        def f_masked(p, m):
            if use_patch:
                return patch_loss(p, ex, ey, et, ep, m, origin)
            return full_loss(p, ex, ey, et, ep, m)

        return f_masked, lambda p: f_masked(p, emask)

    def _refine(ex, ey, et, ep, emask, origin, refine_mask, x0, trust=None):
        """The GD refine from ``x0`` (its loss under ``refine_mask``, the
        iterate clamped to ``trust`` around ``x0`` where given) and its
        answer's loss under the full masks: one body, run eagerly or
        captured and replayed (``RefineGraphs``)."""
        f_masked, f = _losses(ex, ey, et, ep, emask, origin)
        clamp = None
        if trust is not None:
            clamp = lambda p: x0 + torch.minimum(torch.maximum(p - x0,
                                                               -trust), trust)
        best_p, _ = _normalized_descent(lambda p: f_masked(p, refine_mask),
                                        x0, maxiter, gd_lr, clamp=clamp)
        # report the objective over the FULL window (reference convention)
        with torch.no_grad():
            return best_p, f(best_p)

    def _finish(ev, x0, trust=None):
        et, emask = ev[2], ev[4]
        refine_mask = emask
        if adaptive:
            # trim each ROI's window to pixel_crossings/|v| seconds (a mask
            # over the valid prefix of its padded batch)
            refine_mask = lifespan_mask(et, x0, pixel_crossings,
                                        minimum_events=min_events,
                                        base_mask=emask, drop_last=False)
            enough = refine_mask.sum(-1) >= torch.clamp(
                emask.sum(-1), max=float(min_events))
            refine_mask = torch.where(enough[:, None], refine_mask, emask)

        if solver == "bfgs":
            f_masked, f = _losses(*ev)
            with profiling.span("cmax.descent"):
                best = minimize_bfgs(
                    _value_and_grad(lambda p: f_masked(p, refine_mask)), x0,
                    maxiter=maxiter, gtol=1e-6).x_k
            with torch.no_grad():
                return best, f(best)

        inputs = (*ev, refine_mask, x0)
        if trust is not None:
            trust = torch.as_tensor(trust, dtype=torch.float32,
                                    device=x0.device)
            if trust.dim() == 1:
                trust = trust[:, None]
            inputs += (trust,)
        if not use_patch:  # the full-frame losses are not audited for capture
            return _refine(*inputs)
        key = (x0.device, tuple((a.dtype, tuple(a.shape)) for a in inputs),
               trust is not None, _settings(obj), _settings(warp),
               tuple(roi_size), tuple(resolution), blur_sigma, patch, maxiter,
               gd_lr)
        return _REFINE_GRAPHS.run(key, inputs, _refine)

    def solve_one(ex, ey, et, ep, emask, origin):
        ev = (ex, ey, et, ep, emask, origin)
        init_range = torch.full((ex.shape[0],), 150.0, device=ex.device)
        if velocity_cap:
            on = emask != 0
            t_last = torch.where(on, et, -torch.inf).amax(-1)
            t_first = torch.where(on, et, torch.inf).amin(-1)
            dt_roi = torch.where(on.any(-1), t_last - t_first, 0.0)
            init_range = torch.clamp(margin / torch.clamp(dt_roi, min=1e-3),
                                     max=150.0)
        x0, _ = grid_search_refine_batched(_losses(*ev)[1], warp.dims,
                                           init_range,
                                           num_samples_per_param=5, iters=6)
        return _finish(ev, x0)

    def refine_one(ex, ey, et, ep, emask, origin, x0):
        return _finish((ex, ey, et, ep, emask, origin),
                       as_f32(x0, ex.device),
                       trust=None if trust_radius in (None, "traced")
                       else trust_radius)

    def refine_one_trust(ex, ey, et, ep, emask, origin, x0, trust):
        return _finish((ex, ey, et, ep, emask, origin),
                       as_f32(x0, ex.device), trust=trust)

    if with_x0:
        return refine_one_trust if trust_radius == "traced" else refine_one
    return solve_one


# ---------------------------------------------------------------------------
# dIWE segmentation + diagnostics
# ---------------------------------------------------------------------------

def segmentation_mask_from_d_iwe(d_iwe, th=None):
    """Motion-segmentation mask by percentile thresholding |dIWE|
    (reference events_cmax.py:78-101). Host numpy."""
    d_iwe = to_numpy(d_iwe)
    th1 = np.percentile(np.abs(d_iwe), 90)
    validx = d_iwe[0].ravel()[np.abs(d_iwe[0].ravel()) > th1]
    validy = d_iwe[1].ravel()[np.abs(d_iwe[1].ravel()) > th1]
    x_c = np.percentile(validx, 95) if validx.size else 0.0
    y_c = np.percentile(validy, 95) if validy.size else 0.0
    thx = x_c if th is None else th
    thy = y_c if th is None else th
    imgx = (d_iwe[0] > thx).astype(int) + (d_iwe[0] < -thx).astype(int)
    imgy = (d_iwe[1] > thy).astype(int) + (d_iwe[1] < -thy).astype(int)
    return np.clip(imgx + imgy, 0, 1)


def _objective_landscape(xs, ys, ts, ps, objective, warpfunc,
                         x_range=(-200, 200), y_range=(-200, 200),
                         resolution: float = 20, img_size=(180, 240),
                         norm_min=None, norm_max=None, device=None):
    """The 2-DoF landscape ``draw_objective_function`` plots: ``-loss`` on
    the ``imshape`` grid of JAX's ``events_cmax.py:1551-1567`` (rows
    ``v_y``, columns ``v_x``, ``resolution`` px/s apart from the ranges'
    lower ends), unblurred, normalised to [0, 1] by ``norm_min`` /
    ``norm_max`` (default the image's own). All samples are one batched
    evaluation (``make_objective_loss``: one batched splat launch
    per ``batch_chunk`` samples), as JAX vmaps them, read once. Returns a
    float32 tensor on the device."""
    width = x_range[1] - x_range[0]
    height = y_range[1] - y_range[0]
    imshape = (int(height / resolution + 0.5), int(width / resolution + 0.5))
    vys, vxs = np.meshgrid(np.arange(imshape[0]), np.arange(imshape[1]),
                           indexing="ij")
    coords = np.stack([vxs.ravel() * resolution + x_range[0],
                       vys.ravel() * resolution + y_range[0]], axis=-1)
    dev, events = _events(xs, ys, ts, ps, device)
    loss = make_objective_loss(objective, warpfunc, tuple(img_size), 0.0,
                               iwe_impl=DEFAULT_IWE_IMPL)
    cs = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    with torch.no_grad():
        img = -loss(cs, *events).reshape(imshape)
    lo = img.min() if norm_min is None else norm_min
    hi = img.max() if norm_max is None else norm_max
    return (img - lo) / ((hi - lo) + 1e-6)


def draw_objective_function(xs, ys, ts, ps, objective=None, warpfunc=None,
                            x_range=(-200, 200), y_range=(-200, 200),
                            gt=(0, 0), show_gt: bool = True,
                            resolution: float = 20, img_size=(180, 240),
                            show_axes: bool = True, norm_min=None,
                            norm_max=None, show: bool = True,
                            save_path: Optional[str] = None, device=None):
    """Sample a 2-DoF objective landscape into a heatmap (reference
    events_cmax.py:103-160; JAX ``events_cmax.py:1534``): the samples on
    the device (``_objective_landscape``), then a matplotlib plot with the
    ground truth's cross-hair. Returns the normalised image (numpy)."""
    objective = (variance_objective(minimum_events=1) if objective is None
                 else objective)
    warpfunc = linvel_warp() if warpfunc is None else warpfunc
    img = to_numpy(_objective_landscape(
        xs, ys, ts, ps, objective, warpfunc, x_range=x_range,
        y_range=y_range, resolution=resolution, img_size=img_size,
        norm_min=norm_min, norm_max=norm_max, device=device))

    import matplotlib.pyplot as plt

    width = x_range[1] - x_range[0]
    height = y_range[1] - y_range[0]
    plt.imshow(img, interpolation="bilinear", cmap="viridis")
    if not show_axes:
        plt.xticks([])
        plt.yticks([])
    else:
        plt.xlabel("$v_x$")
        plt.ylabel("$v_y$")
    if show_gt:
        xloc = ((gt[0] - x_range[0]) / width) * img.shape[1]
        yloc = ((gt[1] - y_range[0]) / height) * img.shape[0]
        plt.axhline(y=yloc, color="r", linestyle="--")
        plt.axvline(x=xloc, color="r", linestyle="--")
    if save_path is not None:
        plt.savefig(save_path)
    if show:
        plt.show()
    return img


def get_hsv_shifted():
    """Shifted-HSV colormap (Mitrokhin et al.; reference
    events_cmax.py:14-26). Imports matplotlib when called."""
    import matplotlib
    from matplotlib.colors import LinearSegmentedColormap

    hsv = matplotlib.colormaps["hsv"]
    colors = [hsv(np.fmod(i + 0.6666, 1.0)) for i in np.arange(0, 0.6666, 0.01)]
    return LinearSegmentedColormap.from_list("hsv_shifted", colors, N=100)
