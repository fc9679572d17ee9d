"""The fused route of the ROI patch loss: one launch of
``cuda_scatter.patch_variance_vg`` for the variance objective's value and
gradient under the linear-velocity warp.

On the CPU (tier 1):

- the dispatch (``events_cmax.fused_patch_variance``): which objective,
  warp, parameter rank, device and patch size take the route; every other
  evaluation gives bit for bit what the composed body gives;
- a float64 spec of the value and the analytic gradient, step by step as
  the kernel computes them, held against autograd through the composed
  body at several shapes (an empty ROI, events at the patch's edges, a
  lifespan mask with zeros, no blur and a wide blur), and the kernel's
  box-restricted blur passes emulated loop for loop against the spec;
- the plain version of the wrapper, and the route through
  ``make_patch_loss`` and the autograd Function, against both.

On the card (``cuda`` marker; this file imports no JAX, so it runs where
JAX is not used): the kernel against the composed body through autograd at
the stream's shapes (108 ROIs, capacity tiers 1024 and 2048, (64, 128)
patches, the 181 x 241 frame), within the loss and gradient limits of
``test_torch_roi_descent.py``, and against its plain version:

    python -m pytest --noconftest -m cuda tests/test_torch_patch_variance.py
"""

import math

import numpy as np
import pytest
import torch

import event_utils_tpu_torch as P
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.models import objectives as O
from event_utils_tpu_torch.models.warps import (linvel_warp,
                                                pure_rotation_warp,
                                                xyztheta_warp)
from event_utils_tpu_torch.ops import cuda_scatter as cs
from event_utils_tpu_torch.ops.blur import gaussian_kernel1d
from event_utils_tpu_torch.utils.event_util import lifespan_mask

PATCH = (64, 128)
ROI = (20, 20)
SENSOR = (40, 60)             # 2 x 3 ROIs of 20 x 20
FP = 41 * 61
# test_torch_roi_descent.py's limits (bf16 against f32 patches there);
# that file imports JAX, so its card cases are here
LOSS_REL = 1e-3
GRAD_COS = 0.999
GRAD_NORM_REL = 1e-2
# the f64 spec against autograd through the f32 body: f32 rounding of
# sums over ~10^3 pixels and slots
SPEC_LOSS_REL = 1e-5
SPEC_GRAD_REL = 1e-4          # of the largest |gradient| of the call


def scene(seed, n, sensor, flow=(12.0, -7.0)):
    """Points moving at ``flow`` px/s over ``sensor``, integer pixels,
    sorted stamps over 0.2 s, polarities +-1."""
    g = np.random.default_rng(seed)
    H, W = sensor
    pts = 120
    px, py = g.uniform(0, W, pts), g.uniform(0, H, pts)
    pol = g.choice([-1.0, 1.0], pts)
    idx = g.integers(0, pts, n)
    ts = np.sort(g.uniform(0, 0.2, n))
    xs = np.floor(px[idx] + flow[0] * ts + g.normal(0, 0.3, n)) % W
    ys = np.floor(py[idx] + flow[1] * ts + g.normal(0, 0.3, n)) % H
    return tuple(a.astype(np.float32) for a in (xs, ys, ts, pol[idx]))


def batches(seed=0, n=3000, sensor=SENSOR, roi=ROI, capacity=None,
            device="cpu"):
    bx, by, bt, bp, bm, org, _ = pc.bucket_events_by_roi(
        *scene(seed, n, sensor), sensor, roi, capacity=capacity,
        device=device)
    return [bx, by, bt, bp, bm, org.to(torch.float32)]


def velocities(R, seed=1, device="cpu"):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.normal(0, 25, (R, 2)) + [12.0, -7.0],
                           dtype=torch.float32, device=device)


def plant_edges(ev, params, roi, patch, q):
    """Move slots 0-7 of ROI ``q`` to patch-local coordinates on the
    patch's edges under ``params``: first and last valid columns and rows,
    and just outside each (those weigh 0)."""
    ex, ey, et, ep, mask, org = ev
    PH, PW = patch
    et = et.clone()
    on = mask[q] != 0
    t0 = et[q][on].max()
    offx = org[q, 1] + roi[1] / 2.0 - PW / 2.0
    offy = org[q, 0] + roi[0] / 2.0 - PH / 2.0
    spots = [(0.25, 10.5), (PW - 1.75, 20.5), (PW - 0.5, 30.5),
             (-0.25, 12.5), (40.5, 0.25), (50.5, PH - 1.75),
             (60.5, PH - 0.5), (70.5, -0.25)]
    ex, ey, mask = ex.clone(), ey.clone(), mask.clone()
    for i, (sx, sy) in enumerate(spots):
        dt = float(et[q, i] - t0)
        ex[q, i] = sx + offx + dt * params[q, 0]
        ey[q, i] = sy + offy + dt * params[q, 1]
        mask[q, i] = 1.0
    return [ex, ey, et, ep, mask, org]


def body_loss(roi=ROI, patch=PATCH, sigma=1.0, fp=FP, obj=None, warp=None):
    return pc.make_patch_loss(linvel_warp() if warp is None else warp, roi,
                              O.variance_objective() if obj is None else obj,
                              patch=patch, blur_sigma=sigma, full_pixels=fp)


def autograd_vg(loss, params, ev):
    p = params.detach().clone().requires_grad_(True)
    v = loss(p, *ev)
    (g,) = torch.autograd.grad(v.sum(), p)
    return v.detach(), g


def taps_of(sigma):
    return (gaussian_kernel1d(sigma) if sigma else np.ones(1))


# ---------------------------------------------------------------------------
# The float64 spec, and the kernel's passes emulated
# ---------------------------------------------------------------------------

def _slots(ev, params, q, roi, patch):
    """Step 1 in float64: t0, dt, patch-local coordinates, weights and
    which slots splat (nonzero weight, all four taps in the patch)."""
    ex, ey, et, ep, mask, org = (torch.as_tensor(a, dtype=torch.float64)
                                 for a in ev)
    PH, PW = patch
    on = mask[q] != 0
    t0 = et[q][on].max() if bool(on.any()) else torch.tensor(0.0,
                                                             dtype=ex.dtype)
    dt = et[q] - t0
    vx, vy = (float(v) for v in params[q])
    px = ex[q] - dt * vx - (org[q, 1] + roi[1] / 2.0 - PW / 2.0)
    py = ey[q] - dt * vy - (org[q, 0] + roi[0] / 2.0 - PH / 2.0)
    x0, y0 = torch.floor(px), torch.floor(py)
    w = ep[q] * mask[q]
    live = ((w != 0) & (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0)
            & (y0 + 1 < PH))
    return dt[live], px[live] - x0[live], py[live] - y0[live], \
        x0[live].long(), y0[live].long(), w[live]


def _corners(fx, fy):
    return (((0, 0), (1 - fx) * (1 - fy)), ((0, 1), fx * (1 - fy)),
            ((1, 0), (1 - fx) * fy), ((1, 1), fx * fy))


def _blur_full(img, k):
    """The zero-padded separable blur, columns then rows, by correlation
    with k (as F.conv2d), over the whole plane, float64."""
    r = len(k) // 2
    H, W = img.shape
    pad = torch.zeros(H + 2 * r, W, dtype=img.dtype)
    pad[r:r + H] = img
    cols = sum(k[j] * pad[j:j + H] for j in range(len(k)))
    pad = torch.zeros(H, W + 2 * r, dtype=img.dtype)
    pad[:, r:r + W] = cols
    return sum(k[j] * pad[:, j:j + W] for j in range(len(k)))


def spec_vg(ev, params, taps, roi=ROI, patch=PATCH, fp=FP):
    """Steps 1-4 of the kernel in float64 over whole planes: the loss
    -(Q/FP - (S/FP)^2) of the blurred splat, and the gradient: dL/diwe =
    -2 iwe/FP + 2 S/FP^2 blurred back by the flipped taps, the bilinear
    fractions' derivatives against it, times -dt, summed."""
    PH, PW = patch
    k = torch.as_tensor(taps, dtype=torch.float64)
    losses, grads = [], []
    for q in range(ev[0].shape[0]):
        dt, fx, fy, ix, iy, w = _slots(ev, params, q, roi, patch)
        img = torch.zeros(PH, PW, dtype=torch.float64)
        for (oy, ox), wt in _corners(fx, fy):
            img.index_put_((iy + oy, ix + ox), w * wt, accumulate=True)
        iwe = _blur_full(img, k)
        Q, S = (iwe * iwe).sum(), iwe.sum()
        losses.append(-(Q / fp - (S / fp) ** 2))
        G = _blur_full(-2 * iwe / fp + 2 * S / fp ** 2, k.flip(0))
        g00, g01 = G[iy, ix], G[iy, ix + 1]
        g10, g11 = G[iy + 1, ix], G[iy + 1, ix + 1]
        gx = w * ((1 - fy) * (g01 - g00) + fy * (g11 - g10))
        gy = w * ((1 - fx) * (g10 - g00) + fx * (g11 - g01))
        grads.append(torch.stack([-(gx * dt).sum(), -(gy * dt).sum()]))
    return torch.stack(losses), torch.stack(grads)


def emulate_kernel_vg(ev, params, taps, roi=ROI, patch=PATCH, fp=FP):
    """The kernel's passes in float64, with its index arithmetic: the
    splat's box of top-left taps [by0, by1) x [bx0, bx1), the box widened
    by r (clamped) for the blurred image, and each pass's tap range j0..j1
    as ``patch_loss_kernels.cu`` computes them (vectorised along the axis
    the range does not depend on). Planes hold NaN where the kernel never
    writes, so a read outside what a pass wrote shows."""
    PH, PW = patch
    k = torch.as_tensor(taps, dtype=torch.float64)
    ntaps, r = len(k), len(k) // 2
    kf = k.flip(0)
    losses, grads = [], []
    for q in range(ev[0].shape[0]):
        dt, fx, fy, ix, iy, w = _slots(ev, params, q, roi, patch)
        a = torch.zeros(PH, PW, dtype=torch.float64)
        b = torch.full((PH, PW), math.nan, dtype=torch.float64)
        for (oy, ox), wt in _corners(fx, fy):
            a.index_put_((iy + oy, ix + ox), w * wt, accumulate=True)
        if len(ix) == 0:
            losses.append(torch.tensor(-0.0, dtype=torch.float64))
            grads.append(torch.zeros(2, dtype=torch.float64))
            continue
        by0, by1 = int(iy.min()), int(iy.max()) + 2
        bx0, bx1 = int(ix.min()), int(ix.max()) + 2
        ry0, ry1 = max(by0 - r, 0), min(by1 + r, PH)
        rx0, rx1 = max(bx0 - r, 0), min(bx1 + r, PW)
        for yy in range(ry0, ry1):                  # columns of the splat
            j0, j1 = max(0, by0 - yy + r), min(ntaps, by1 - yy + r)
            b[yy, bx0:bx1] = sum((k[j] * a[yy + j - r, bx0:bx1]
                                  for j in range(j0, j1)),
                                 torch.zeros(bx1 - bx0, dtype=a.dtype))
        for xx in range(rx0, rx1):                  # rows: the IWE
            j0, j1 = max(0, bx0 - xx + r), min(ntaps, bx1 - xx + r)
            a[ry0:ry1, xx] = sum((k[j] * b[ry0:ry1, xx + j - r]
                                  for j in range(j0, j1)),
                                 torch.zeros(ry1 - ry0, dtype=a.dtype))
        Q = (a[ry0:ry1, rx0:rx1] ** 2).sum()
        S = a[ry0:ry1, rx0:rx1].sum()
        losses.append(-(Q / fp - (S / fp) ** 2))
        cA, cB = -2.0 / fp, 2.0 * S / (fp * fp)
        for yy in range(by0, by1):                  # columns of g
            j0, j1 = max(0, r - yy), min(ntaps, PH - yy + r)
            b[yy, rx0:rx1] = sum((kf[j] * (cA * a[yy + j - r, rx0:rx1] + cB)
                                  for j in range(j0, j1)),
                                 torch.zeros(rx1 - rx0, dtype=a.dtype))
        for xx in range(bx0, bx1):                  # rows: G
            j0, j1 = max(0, r - xx), min(ntaps, PW - xx + r)
            a[by0:by1, xx] = sum((kf[j] * b[by0:by1, xx + j - r]
                                  for j in range(j0, j1)),
                                 torch.zeros(by1 - by0, dtype=a.dtype))
        g00, g01 = a[iy, ix], a[iy, ix + 1]
        g10, g11 = a[iy + 1, ix], a[iy + 1, ix + 1]
        gx = w * ((1 - fy) * (g01 - g00) + fy * (g11 - g10))
        gy = w * ((1 - fx) * (g10 - g00) + fx * (g11 - g01))
        grads.append(torch.stack([-(gx * dt).sum(), -(gy * dt).sum()]))
    return torch.stack(losses), torch.stack(grads)


# The shapes the spec is held at: (case, roi, patch, sigma, capacity)
SPEC_CASES = {
    "stream": (ROI, PATCH, 1.0, None),
    "small_capacity": (ROI, PATCH, 1.0, 64),
    "no_blur": (ROI, PATCH, 0.0, None),
    "wide_blur": (ROI, PATCH, 2.0, None),
    "small_patch": ((10, 10), (24, 32), 1.0, None),
}


def spec_inputs(case, seed=0):
    """Inputs of a spec case: the bucketed scene, velocities, ROI 1
    emptied, ROI 2's slots 0-7 on the patch's edges, ROI 3 under a
    lifespan mask with zeros, ROI 4 with zero polarities."""
    roi, patch, sigma, capacity = SPEC_CASES[case]
    ev = batches(seed, roi=roi, capacity=capacity)
    R = ev[0].shape[0]
    params = velocities(R, seed + 1)
    ev = plant_edges(ev, params, roi, patch, 2)
    mask = ev[4].clone()
    mask[1] = 0.0
    # a lifespan cut as at 20x the velocities: the oldest slots drop
    life = lifespan_mask(ev[2], 20.0 * params, 5, minimum_events=10,
                         base_mask=ev[4], drop_last=False)
    mask[3] = life[3]
    ev[3] = ev[3].clone()
    ev[3][4, ::3] = 0.0
    ev[4] = mask
    fp = (SENSOR[0] + 1) * (SENSOR[1] + 1)
    return ev, params, roi, patch, sigma, fp


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_matches_autograd_through_the_body(case):
    ev, params, roi, patch, sigma, fp = spec_inputs(case)
    assert bool((ev[4][3] == 0).any()) and bool((ev[4][3] != 0).any())
    v, g = autograd_vg(body_loss(roi, patch, sigma, fp), params, ev)
    sv, sg = spec_vg(ev, params, taps_of(sigma), roi, patch, fp)
    np.testing.assert_allclose(v.double(), sv, rtol=SPEC_LOSS_REL)
    assert float(sv[1]) == 0.0 and torch.equal(sg[1], torch.zeros(2,
                                                   dtype=torch.float64))
    err = float((g.double() - sg).abs().max())
    assert err <= SPEC_GRAD_REL * float(sg.abs().max()), err


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_kernel_passes_emulated_match_the_spec(case):
    ev, params, roi, patch, sigma, fp = spec_inputs(case)
    sv, sg = spec_vg(ev, params, taps_of(sigma), roi, patch, fp)
    ev_, eg = emulate_kernel_vg(ev, params, taps_of(sigma), roi, patch, fp)
    assert bool(torch.isfinite(ev_).all()) and bool(torch.isfinite(eg).all())
    np.testing.assert_allclose(ev_, sv, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(eg, sg, rtol=1e-9,
                               atol=1e-12 * float(sg.abs().max()))


def test_edge_slots_splat_only_inside_the_patch():
    """Of the eight planted slots, the four whose taps all lie inside the
    patch splat; the four a hair outside weigh 0."""
    ev, params, roi, patch, sigma, fp = spec_inputs("stream")
    ev[3] = ev[3].clone()
    ev[3][2, 8:] = 0.0          # only the planted slots weigh
    *_, ix, iy, w = _slots(ev, params, 2, roi, patch)
    assert sorted(zip(ix.tolist(), iy.tolist())) == sorted(
        [(0, 10), (patch[1] - 2, 20), (40, 0), (50, patch[0] - 2)])


# ---------------------------------------------------------------------------
# The plain version and the route through make_patch_loss, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The route engages on the CPU, where the wrapper runs its plain
    version; records each call's ``grad`` flag."""
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "cpu")
    calls = []
    wrapper = cs.patch_variance_vg

    def spy(*args, **kw):
        calls.append(kw.get("grad", True))
        return wrapper(*args, **kw)

    monkeypatch.setattr(cs, "patch_variance_vg", spy)
    return calls


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_plain_version_matches_the_spec(case):
    ev, params, roi, patch, sigma, fp = spec_inputs(case)
    taps = torch.as_tensor(taps_of(sigma), dtype=torch.float32)
    v, g = cs.patch_variance_vg(*(a.contiguous() for a in ev[:6]), params,
                                taps, roi, patch, fp)
    sv, sg = spec_vg(ev, params, taps_of(sigma), roi, patch, fp)
    np.testing.assert_allclose(v.double(), sv, rtol=SPEC_LOSS_REL)
    err = float((g.double() - sg).abs().max())
    assert err <= SPEC_GRAD_REL * float(sg.abs().max()), err
    v2, none = cs.patch_variance_vg(*(a.contiguous() for a in ev[:6]),
                                    params, taps, roi, patch, fp, grad=False)
    assert none is None and torch.equal(v, v2)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_route_value_equals_the_body_and_gradient_the_spec(case,
                                                           fused_on_cpu):
    """Through make_patch_loss: the route's value on the CPU is the body's
    bit for bit (the plain version repeats its f32 operations), its
    gradient the spec's; value-only calls ask for no gradient."""
    ev, params, roi, patch, sigma, fp = spec_inputs(case)
    loss = body_loss(roi, patch, sigma, fp)
    v, g = autograd_vg(loss, params, ev)
    assert fused_on_cpu == [True]
    with torch.no_grad():
        v0 = loss(params, *ev)
    assert fused_on_cpu == [True, False]
    fused_on_cpu.clear()
    pc.FUSED_DEVICE_TYPE = "cuda"
    vb, _ = autograd_vg(loss, params, ev)
    assert fused_on_cpu == []
    assert torch.equal(v, vb) and torch.equal(v0, vb)
    _, sg = spec_vg(ev, params, taps_of(sigma), roi, patch, fp)
    err = float((g.double() - sg).abs().max())
    assert err <= SPEC_GRAD_REL * float(sg.abs().max()), err


def test_route_backward_scales_by_the_cotangent(fused_on_cpu):
    ev, params, *_ = spec_inputs("stream")
    loss = body_loss(fp=(SENSOR[0] + 1) * (SENSOR[1] + 1))
    p = params.clone().requires_grad_(True)
    v = loss(p, *ev)
    w = torch.linspace(-2, 3, v.shape[0])
    (g,) = torch.autograd.grad((v * w).sum(), p)
    _, g1 = autograd_vg(loss, params, ev)
    torch.testing.assert_close(g, w[:, None] * g1, rtol=0, atol=0)


def test_route_one_roi_as_vectors(fused_on_cpu):
    """A single ROI as 1-D events with (2,) params: a scalar, as the
    body."""
    ev, params, roi, patch, sigma, fp = spec_inputs("stream")
    loss = body_loss(fp=fp)
    one = [a[5] for a in ev]
    p = params[5].clone().requires_grad_(True)
    v = loss(p, *one)
    (g,) = torch.autograd.grad(v, p)
    assert v.dim() == 0 and fused_on_cpu == [True]
    vr, gr = autograd_vg(loss, params, ev)
    torch.testing.assert_close(v.detach(), vr[5], rtol=1e-6, atol=0)
    torch.testing.assert_close(g, gr[5], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")
OTHER_OBJECTIVES = ["sos", "rms", "soe", "sosa", "isoa", "moa", "r1", "zhu"]


class _Linvel(linvel_warp):
    """A subclass may warp otherwise: not the route's warp."""


class _Variance(O.variance_objective):
    """A subclass may score otherwise: not the route's objective."""


DISPATCH = {
    # name: (objective, warp, params shape, device, patch, radius), engages
    "stream": ((O.variance_objective(), linvel_warp(), (108, 2), CUDA,
                PATCH, 4), True),
    "lifespan_variance": ((O.variance_objective(adaptive_lifespan=True),
                           linvel_warp(), (5, 2), "cuda:0", PATCH, 4), True),
    "no_blur": ((O.variance_objective(), linvel_warp(), (5, 2), CUDA, PATCH,
                 0), True),
    "largest_patch": ((O.variance_objective(), linvel_warp(), (5, 2), CUDA,
                       (112, 256), 4), True),
    "patch_past_227kb": ((O.variance_objective(), linvel_warp(), (5, 2),
                          CUDA, (128, 256), 4), False),
    "samples": ((O.variance_objective(), linvel_warp(), (108, 25, 2), CUDA,
                 PATCH, 4), False),
    "one_sample": ((O.variance_objective(), linvel_warp(), (108, 1, 2),
                    CUDA, PATCH, 4), False),
    "cpu": ((O.variance_objective(), linvel_warp(), (108, 2), "cpu", PATCH,
             4), False),
    "xyztheta": ((O.variance_objective(), xyztheta_warp(), (108, 4), CUDA,
                  PATCH, 4), False),
    "rotation": ((O.variance_objective(), pure_rotation_warp(), (108, 3),
                  CUDA, PATCH, 4), False),
    "warp_subclass": ((O.variance_objective(), _Linvel(), (108, 2), CUDA,
                       PATCH, 4), False),
    "objective_subclass": ((_Variance(), linvel_warp(), (108, 2), CUDA,
                            PATCH, 4), False),
    **{name: ((O.OBJECTIVE_REGISTRY[name](), linvel_warp(), (108, 2), CUDA,
               PATCH, 4), False) for name in OTHER_OBJECTIVES},
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_table(case):
    args, engages = DISPATCH[case]
    assert pc.fused_patch_variance(*args) is engages


def test_wrapper_checks_its_inputs():
    ev, params, roi, patch, sigma, fp = spec_inputs("stream")
    ev = [a.contiguous() for a in ev]
    taps = torch.as_tensor(taps_of(1.0), dtype=torch.float32)
    bad = {
        "f64_params": (ev, params.double(), taps, patch),
        "even_taps": (ev, params, taps[:8], patch),
        "params_rank": (ev, params[:, None], taps, patch),
        "short_origin": (ev[:5] + [ev[5][:2]], params, taps, patch),
        "strided": ([ev[0].t().contiguous().t()] + ev[1:], params, taps,
                    patch),
        "past_227kb": (ev, params, taps, (128, 256)),
    }
    for name, (e, p, k, pt) in bad.items():
        with pytest.raises(P.errors.ConfigurationError):
            cs.patch_variance_vg(*e, p, k, roi, pt, fp)
    assert not cs.launch_counts()["patch_variance_vg"] and \
        cs.KERNEL_WRAPPERS["patch_variance_vg"] is cs.patch_variance_vg


def test_patch_loss_routes_are_the_kernel_routes_of_an_evaluation():
    """The routes of which one patch-loss evaluation launches one, as the
    stream CLI reads them: the fused kernel's first, then the composed
    body's two patch splats, each a counted route with its wrapper."""
    assert pc.FUSED_PATCH_ROUTE == pc.PATCH_LOSS_ROUTES[0] == \
        "patch_variance_vg"
    assert pc.PATCH_LOSS_ROUTES[1:] == ("bilinear_patches_scatter",
                                        "bilinear_patches_scatter:direct")
    assert cs.KERNEL_WRAPPERS[pc.FUSED_PATCH_ROUTE] is cs.patch_variance_vg
    for route in pc.PATCH_LOSS_ROUTES[1:]:
        assert cs.KERNEL_WRAPPERS[route] is cs.bilinear_patches_scatter
    assert set(pc.PATCH_LOSS_ROUTES) <= set(cs.launch_counts())


def test_the_limit_is_two_planes_and_the_taps_in_227kb():
    assert cs.patch_variance_shared_bytes(64, 128, 4) == 4 * (
        2 * 64 * 128 + 12 + 64 + 4)
    assert cs.patch_variance_fits(64, 128, 4)
    assert cs.patch_variance_fits(113, 256, 4)
    assert not cs.patch_variance_fits(114, 256, 4)
    assert not cs.patch_variance_fits(128, 256, 0)


# Evaluations outside the route, each with the route enabled on the CPU:
# (name, objective, warp, patch, params of ROI r)
OUTSIDE = {
    "samples": (O.variance_objective(), linvel_warp(), PATCH,
                lambda p: torch.stack([p, p + 3.0, p - 2.0], 1)),
    **{name: (O.OBJECTIVE_REGISTRY[name](), linvel_warp(), PATCH,
              lambda p: p) for name in OTHER_OBJECTIVES},
    "xyztheta": (O.variance_objective(), xyztheta_warp(), PATCH,
                 lambda p: torch.cat([p, 0.1 * p], -1)),
    "warp_subclass": (O.variance_objective(), _Linvel(), PATCH,
                      lambda p: p),
    "patch_past_227kb": (O.variance_objective(), linvel_warp(), (128, 256),
                         lambda p: p),
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_outside_the_route_the_body_is_unchanged(case, monkeypatch):
    """Every other evaluation runs the composed body: with the route
    enabled on the CPU it gives what it gives with the route off, bit for
    bit, value and gradient, and the wrapper is never called."""
    obj, warp, patch, make = OUTSIDE[case]
    ev, params, roi, _, sigma, fp = spec_inputs("stream")
    params = make(params)
    loss = body_loss(roi, patch, sigma, fp, obj=obj, warp=warp)
    want = autograd_vg(loss, params, ev)
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(cs, "patch_variance_vg", None)   # never called
    got = autograd_vg(loss, params, ev)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_events_that_require_grad_keep_the_body(monkeypatch):
    ev, params, roi, patch, sigma, fp = spec_inputs("stream")
    loss = body_loss(roi, patch, sigma, fp)
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(cs, "patch_variance_vg", None)
    ex = ev[0].clone().requires_grad_(True)
    v = loss(params, ex, *ev[1:])
    (gx,) = torch.autograd.grad(v.sum(), ex)
    assert gx.abs().sum() > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def stream_inputs(capacity, seed=3, device="cuda"):
    """One 20k-event window of a rotating scene (400 points at 1.2 rad/s
    about the centre of 180 x 240, integer pixels) bucketed into 108 ROIs
    of 20 x 20 at ``capacity``; velocities of the rotation with noise; ROI
    7 emptied, ROI 2's slots on the patch's edges, a lifespan mask with
    zeros on the others."""
    g = np.random.default_rng(seed)
    H, W = 180, 240
    n = 20_000
    px, py = g.uniform(10, W - 10, 400), g.uniform(10, H - 10, 400)
    pol = g.choice([-1.0, 1.0], 400)
    idx = g.integers(0, 400, n)
    ts = np.sort(g.uniform(0, n / 1e6, n))
    rx, ry = px[idx] - W / 2, py[idx] - H / 2
    ca, sa = np.cos(1.2 * ts), np.sin(1.2 * ts)
    xs = np.clip(np.floor(W / 2 + ca * rx - sa * ry), 0, W - 1)
    ys = np.clip(np.floor(H / 2 + sa * rx + ca * ry), 0, H - 1)
    bx, by, bt, bp, bm, org, _ = pc.bucket_events_by_roi(
        *(a.astype(np.float32) for a in (xs, ys, ts, pol[idx])), (H, W),
        ROI, capacity=capacity, device=device)
    ev = [bx, by, bt, bp, bm, org.to(torch.float32)]
    oy, ox = org[:, 0].float() + 10 - H / 2, org[:, 1].float() + 10 - W / 2
    params = torch.stack([-1.2 * oy, 1.2 * ox], -1) + torch.as_tensor(
        g.normal(0, 8, (108, 2)), dtype=torch.float32, device=device)
    ev = plant_edges(ev, params, ROI, PATCH, 2)
    life = lifespan_mask(ev[2], params, 5, minimum_events=105,
                         base_mask=ev[4], drop_last=False)
    ev[4] = life.to(torch.float32)
    ev[4][2] = torch.where(torch.arange(capacity, device=device) < 8, 1.0,
                           ev[4][2])
    ev[4][7] = 0.0
    return ev, params


def _card_body_and_route(ev, params, monkeypatch):
    loss = body_loss(fp=181 * 241)
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "none")
    before = cs.launch_counts()
    body = autograd_vg(loss, params, ev)
    body_launches = {k: v - before[k] for k, v in cs.launch_counts().items()
                     if v != before[k]}
    monkeypatch.setattr(pc, "FUSED_DEVICE_TYPE", "cuda")
    before = cs.launch_counts()
    route = autograd_vg(loss, params, ev)
    route_launches = {k: v - before[k] for k, v in
                      cs.launch_counts().items() if v != before[k]}
    assert body_launches == {"bilinear_patches_scatter:direct": 1}
    assert route_launches == {"patch_variance_vg": 1}
    return loss, body, route


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1024, 2048])
def test_card_route_matches_the_body_at_the_streams_shapes(
        cuda, monkeypatch, capacity):
    ev, params = stream_inputs(capacity)
    assert bool((ev[4] == 0).any()) and ev[0].shape == (108, capacity)
    loss, (vb, gb), (vr, gr) = _card_body_and_route(ev, params, monkeypatch)
    np.testing.assert_allclose(vr.cpu(), vb.cpu(), rtol=LOSS_REL)
    assert float(vr[7]) == 0.0 and bool((gr[7] == 0).all())
    live = gb.norm(dim=-1) > 0
    cos = torch.nn.functional.cosine_similarity(gr[live], gb[live], dim=-1)
    assert float(cos.min()) >= GRAD_COS
    np.testing.assert_allclose(gr[live].norm(dim=-1).cpu(),
                               gb[live].norm(dim=-1).cpu(),
                               rtol=GRAD_NORM_REL)
    loss_err = float(((vr - vb).abs() / vb.abs().clamp(min=1e-30)).max())
    grad_err = float((gr - gb).abs().max() / gb.abs().max())
    print(f"C={capacity}: loss rel {loss_err:.3e}, gradient "
          f"{grad_err:.3e} of the largest, cosine min {float(cos.min()):.9f}")


@pytest.mark.cuda
def test_card_value_only_calls_skip_the_gradient(cuda, monkeypatch):
    """Under no_grad (the descent's first and last evaluation, the
    full-mask report) the route launches once without the gradient and
    gives the value of a call with it."""
    ev, params = stream_inputs(2048)
    loss = body_loss(fp=181 * 241)
    flags = []
    wrapper = cs.patch_variance_vg

    def spy(*args, **kw):
        flags.append(kw.get("grad", True))
        return wrapper(*args, **kw)

    monkeypatch.setattr(cs, "patch_variance_vg", spy)
    with torch.no_grad():
        v0 = loss(params, *ev)
    v1, _ = autograd_vg(loss, params, ev)
    assert flags == [False, True]
    np.testing.assert_allclose(v0.cpu(), v1.cpu(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1024, 2048])
def test_card_kernel_matches_its_plain_version(cuda, capacity):
    ev, params = stream_inputs(capacity)
    taps = torch.as_tensor(gaussian_kernel1d(1.0), dtype=torch.float32,
                           device=cuda)
    args = ([a.contiguous() for a in ev], params, taps, ROI, PATCH,
            181 * 241)
    before = cs.launch_counts()["patch_variance_vg"]
    v, g = cs.patch_variance_vg(*args[0], *args[1:])
    assert cs.launch_counts()["patch_variance_vg"] == before + 1
    pv, pg = cs.patch_variance_vg_plain(*args[0], *args[1:])
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=0)
    assert float((g - pg).abs().max()) <= 1e-4 * float(pg.abs().max())
