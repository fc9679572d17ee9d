"""Plain reference of the configuration ``cmax-davis240``: contrast
maximisation of the variance objective on a DAVIS240 stream, in plain
PyTorch and NumPy. It imports nothing of the program under test and takes
nothing it made: events come from the recording's raw files, and every grid,
image and solve is worked out again here.

The ROI solver of ``grid_cmax_batched``, with the semantics the program
documents: a linear velocity a ROI; events bucketed by ROI in time order;
each ROI's warped events splat bilinearly into a (64, 128) patch about it,
an event dropped when a tap leaves the patch; a zero-padded Gaussian blur;
the loss ``-(Q/FP - (S/FP)^2)`` with FP = (H+1)(W+1); a velocity-capped
coarse-to-fine grid search when no warm start is given, then
normalised-gradient descent with momentum 0.8, a cosine step and
best-iterate tracking; ``valid`` where a ROI holds more than
``min_events`` events.

``dtype`` is the precision of everything after the events' time offsets
(which are taken in float32, as the program's inputs are): float32 is the
configuration's, bfloat16 the control's.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = (64, 128)


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions in float32, not TF32, whatever the process
    set."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def gauss_k1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    r = int(truncate * float(sigma) + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return k / k.sum()


def _blur(img, k1d):
    """Separable 'same' blur of the last two axes, zero-padded."""
    k = torch.as_tensor(k1d, dtype=img.dtype, device=img.device)
    r = k.shape[0] // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    with no_tf32():
        x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(r, 0))
        x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# ROI solver
# ---------------------------------------------------------------------------

def bucket(xs, ys, ts, ps, sensor, roi, cap_max=2048):
    """Events of each ROI (row-major ids) in time order, padded to the
    largest count rounded up to a power of two (at most ``cap_max``):
    ``(x, y, t, p, mask)`` (R, C) float32 numpy and the counts (R,)."""
    H, W = sensor
    rh, rw = roi
    ny, nx = -(-H // rh), -(-W // rw)
    rid = (np.clip(ys.astype(np.int64) // rh, 0, ny - 1) * nx
           + np.clip(xs.astype(np.int64) // rw, 0, nx - 1))
    counts = np.bincount(rid, minlength=ny * nx)
    cap = max(1, int(2 ** math.ceil(math.log2(max(int(counts.max()), 1)))))
    cap = min(cap, cap_max)
    if counts.max() > cap:
        raise ValueError(f"a ROI holds {counts.max()} events, past the "
                         f"capacity {cap}: the overflow tier is not covered")
    order = np.argsort(rid, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(order)) - starts[rid[order]]
    flat = rid[order] * cap + slot
    out = []
    for a in (xs, ys, ts, ps, np.ones(len(xs))):
        b = np.zeros(ny * nx * cap, np.float32)
        b[flat] = np.asarray(a, np.float32)[order]
        out.append(b.reshape(ny * nx, cap))
    oy, ox = np.divmod(np.arange(ny * nx), nx)
    origins = np.stack([oy * rh, ox * rw], -1).astype(np.float32)
    return out, origins, counts


class RoiProblem:
    """The ROI solver's loss over (R, C) bucketed events on one device, in
    ``dtype``."""

    def __init__(self, buckets, origins, sensor, roi, blur_sigma, dtype,
                 device):
        bx, by, bt, bp, bm = (torch.as_tensor(a, device=device)
                              for a in buckets)
        on = bm != 0
        any_on = on.any(-1)
        t0 = torch.where(any_on, torch.where(on, bt, -torch.inf).amax(-1),
                         0.0)
        # time offsets in float32, as the program's float32 inputs give them
        self.dt = (bt - t0[:, None]).to(dtype)
        t_last = torch.where(on, bt, -torch.inf).amax(-1)
        t_first = torch.where(on, bt, torch.inf).amin(-1)
        self.dt_roi = torch.where(any_on, t_last - t_first, 0.0)
        self.x, self.y = bx.to(dtype), by.to(dtype)
        self.w = (bp * bm).to(dtype)
        self.count = bm.sum(1)
        rh, rw = roi
        PH, PW = PATCH
        org = torch.as_tensor(origins, device=device)
        self.ox = (org[:, 1] + rw / 2.0 - PW / 2.0).to(dtype)
        self.oy = (org[:, 0] + rh / 2.0 - PH / 2.0).to(dtype)
        self.FP = float((sensor[0] + 1) * (sensor[1] + 1))
        self.k1d = gauss_k1d(blur_sigma) if blur_sigma else None
        self.dtype, self.device = dtype, device

    def loss(self, params):
        """(R, S, 2) or (R, 2) linear velocities -> (R, S) or (R,) losses."""
        single = params.dim() == 2
        p = (params[:, None] if single else params).to(self.dtype)
        R, S, _ = p.shape
        PH, PW = PATCH
        px = (self.x[:, None] - self.dt[:, None] * p[..., 0:1]
              - self.ox[:, None, None])
        py = (self.y[:, None] - self.dt[:, None] * p[..., 1:2]
              - self.oy[:, None, None])
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = px - x0, py - y0
        inside = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
        w = self.w[:, None] * inside.to(self.dtype)
        base = (torch.arange(R * S, device=self.device).view(R, S, 1)
                * (PH * PW))
        ix = torch.where(inside, x0, 0).long()
        iy = torch.where(inside, y0, 0).long()
        img = torch.zeros(R * S * PH * PW, dtype=self.dtype,
                          device=self.device)
        for oy, ox, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                           (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            ids = base + (iy + oy) * PW + (ix + ox)
            img = img.index_add(0, ids.reshape(-1), (w * wt).reshape(-1))
        img = img.view(R, S, PH, PW)
        if self.k1d is not None:
            img = _blur(img, self.k1d)
        Q = (img * img).sum((-2, -1))
        s = img.sum((-2, -1))
        out = -(Q / self.FP - (s / self.FP) ** 2)
        return out[:, 0] if single else out


def grid_search(loss, init_range, dims, iters, samples=5):
    """Coarse-to-fine search of R problems at once: ``samples`` points an
    axis about the best so far ('ij' order, the first of equal minima), the
    step halved each level. ``init_range`` (R,) half-ranges."""
    R = init_range.shape[0]
    dev, dtype = init_range.device, init_range.dtype
    scale = torch.linspace(0, 1.0, samples // 2 + 1, dtype=dtype,
                           device=dev)[1:]
    n = 2 * scale.shape[0] + 1
    idx = torch.as_tensor(np.stack(np.meshgrid(*[np.arange(n)] * dims,
                                               indexing="ij"),
                                   -1).reshape(-1, dims), device=dev)
    dim_idx = torch.arange(dims, device=dev)[None, :]
    rows = torch.arange(R, device=dev)
    lo = -init_range[:, None].expand(R, dims)
    hi = init_range[:, None].expand(R, dims)
    best_p = torch.zeros((R, dims), dtype=dtype, device=dev)
    best_e = torch.full((R,), torch.inf, dtype=dtype, device=dev)
    with torch.no_grad():
        for _ in range(iters):
            span = hi - lo
            mid = lo + span / 2.0
            pos = mid[..., None] + scale * (span[..., None] / 2.0)
            neg = torch.flip(mid[..., None] - scale * (span[..., None] / 2.0),
                             dims=(-1,))
            axes = torch.cat([neg, mid[..., None], pos], -1)
            coords = axes[:, dim_idx, idx]
            evals = loss(coords)
            best = torch.argmin(evals, dim=-1)
            cand_p, cand_e = coords[rows, best], evals[rows, best]
            better = cand_e < best_e
            best_p = torch.where(better[:, None], cand_p, best_p)
            best_e = torch.where(better, cand_e, best_e)
            step = (axes[..., 1:] - axes[..., :-1]).amax(-1)
            lo, hi = cand_p - step, cand_p + step
    return best_p


def descent(f, x0, maxiter, lr0, clamp=None):
    """Normalised-gradient descent, momentum 0.8, cosine step, the best
    iterate kept (the start and the last included)."""
    def vg(p):
        with torch.enable_grad():
            p = p.detach().requires_grad_(True)
            v = f(p)
            (g,) = torch.autograd.grad(v.sum(), p)
        return v.detach(), g

    with torch.no_grad():
        p = x0
        m = torch.zeros_like(x0)
        best_p, best_v = x0, f(x0)
        for i in range(maxiter):
            v, g = vg(p)
            better = v < best_v
            best_p = torch.where(better[:, None], p, best_p)
            best_v = torch.where(better, v, best_v)
            g = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                     + 1e-12)
            m = 0.8 * m + g
            p = p - lr0 * 0.5 * (1 + math.cos(math.pi * i / maxiter)) * m
            if clamp is not None:
                p = clamp(p)
        v = f(p)
        better = v < best_v
        best_p = torch.where(better[:, None], p, best_p)
    return best_p


def solve_rois(xs, ys, ts, ps, sensor, roi, x0, maxiter, min_events,
               blur_sigma=1.0, gd_lr=4.0, dtype=torch.float32, device="cuda"):
    """One window's ROI solve: ``(params (R, 2), losses (R,), valid (R,))``
    as float32 tensors. ``x0`` (R, 2) warm-starts every ROI (no grid
    search); None searches first."""
    buckets, origins, _ = bucket(xs, ys, ts, ps, sensor, roi)
    prob = RoiProblem(buckets, origins, sensor, roi, blur_sigma, dtype,
                      device)
    if x0 is None:
        margin = min(PATCH[0] - roi[0], PATCH[1] - roi[1]) / 2.0 - 2.0
        r0 = torch.clamp(margin / torch.clamp(prob.dt_roi, min=1e-3),
                         max=150.0).to(dtype)
        start = grid_search(prob.loss, r0, 2, iters=6)
        clamp = None
    else:
        start = torch.as_tensor(x0, device=device).to(dtype)
        # the warm solver's trust ball, infinite radius: x0 + (p - x0)
        clamp = lambda p: start + (p - start)  # noqa: E731
    best = descent(prob.loss, start, maxiter, gd_lr, clamp=clamp)
    with torch.no_grad():
        f = prob.loss(best)
    return (best.float(), f.float(), prob.count > min_events)


def roi_losses(xs, ys, ts, ps, sensor, roi, params, blur_sigma=1.0,
               device="cuda"):
    """The float32 ROI losses at given (R, 2) params."""
    buckets, origins, _ = bucket(xs, ys, ts, ps, sensor, roi)
    prob = RoiProblem(buckets, origins, sensor, roi, blur_sigma,
                      torch.float32, device)
    with torch.no_grad():
        return prob.loss(torch.as_tensor(params, dtype=torch.float32,
                                         device=device))
