"""Parity of the port's ROI solvers against the JAX package, on the CPU:
``grid_cmax_batched`` with each of its options, the warm refine with its
trust radius, ``fit_global_motion`` and the host loop ``grid_cmax``.

The same numpy scenes from a seed go through both packages; the port runs
with ``device="cpu"``. ``rois`` and ``valid`` must be equal. The params
are the end of a normalised-gradient descent with learning rate 4 px/s:
its steps are the same size whatever the gradient's magnitude, so the last
bits of a loss (JAX forms the patch IWE as a bf16 matmul, the port in f32)
move an ROI's answer within the basin. Tolerances, in px/s: 1.5 per ROI and
0.5 for the median over valid ROIs against JAX; 2.0 against the planted
flow where the JAX tests ask 4-5. Losses: 5e-2 relative for the per-ROI
``f_evals`` (each is the loss at that ROI's own answer, which may sit up to
1.5 px/s from JAX's), 1e-2 for the global fit and the host loop.

An ROI may lie between two basins of nearly equal loss, and the descent's
best-iterate pick then turns on the last bits of the loss. The objectives
test admits such an ROI only on evidence: where the port's answer departs
from JAX's by more than 1.5 px/s, the JAX package's own patch loss must rate
the port's answer no worse than JAX's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.convert import objective_from_jax
from test_torch_roi import flow_scene

torch.set_num_threads(1)

CPU = "cpu"
ROI_ATOL = 1.5     # px/s, per ROI against JAX
MED_ATOL = 0.5     # px/s, the valid-ROI median against JAX
LOSS_REL = 1e-2
F_EVAL_REL = 5e-2
TIE_REL = 1e-3     # a departing ROI's JAX loss against JAX's own answer's
SMALL = (24, 32)
FLOW = (10.0, 5.0)


@pytest.fixture(scope="module")
def small_scene():
    return flow_scene(np.random.default_rng(0), *FLOW, 6000, SMALL)


def both(scene, **kw):
    """grid_cmax_batched of both packages on one scene; the port's output
    as numpy."""
    jax_kw = {k: (v if k != "obj" else v[0]) for k, v in kw.items()}
    port_kw = {k: (v if k != "obj" else v[1]) for k, v in kw.items()}
    ref = jc.grid_cmax_batched(*scene, **jax_kw)
    got = pc.grid_cmax_batched(*scene, device=CPU, **port_kw)
    return ([np.asarray(a) for a in ref],
            [a.numpy() for a in got])


def check(ref, got, truth=FLOW, jax_loss=None):
    """Hold the port's result against JAX's. ``jax_loss`` (params (R, 2) ->
    the JAX patch loss of every ROI, numpy) admits ROIs further than
    ROI_ATOL from JAX's answer where that loss rates the port's answer no
    worse (to TIE_REL) than JAX's own; without it every ROI must be near."""
    (jp, jr, jf, jv), (pp, pr, pf, pv) = ref, got
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pv, jv)
    assert pp.shape == jp.shape and pp.dtype == np.float32
    far = np.abs(pp - jp).max(axis=1) > ROI_ATOL
    if jax_loss is None or not far.any():
        np.testing.assert_allclose(pp, jp, atol=ROI_ATOL)
    else:
        np.testing.assert_allclose(pp[~far], jp[~far], atol=ROI_ATOL)
        at_port, at_jax = jax_loss(pp), jax_loss(jp)
        limit = at_jax[far] + TIE_REL * np.abs(at_jax[far])
        assert np.all(at_port[far] <= limit), (
            f"ROIs {np.flatnonzero(far).tolist()} are over {ROI_ATOL} px/s "
            f"from JAX's answer at a worse JAX loss: {at_port[far]} vs "
            f"{at_jax[far]}")
    med = np.median(pp[pv], axis=0)
    np.testing.assert_allclose(med, np.median(jp[jv], axis=0), atol=MED_ATOL)
    np.testing.assert_allclose(med, truth, atol=2.0)
    np.testing.assert_allclose(pf, jf, rtol=F_EVAL_REL, atol=1e-6)


OPTIONS = {
    "plain": {},
    "median": {"smooth": "median"},
    "x0": {"x0": np.tile(np.float32([[9.0, 4.0]]), (4, 1))},
    "x0_trust": {"x0": np.tile(np.float32([[9.0, 4.0]]), (4, 1)),
                 "trust_radius": 0.5},
    "overflow_refine": {"capacity": 512},
    "no_overflow_refine": {"capacity": 512, "overflow_refine": False},
    "pyramid2": {"pyramid": 2},
    "auto": {"pyramid": "auto"},
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_grid_cmax_batched_options(small_scene, option):
    kw = dict(roi_size=(12, 16), img_size=SMALL, maxiter=15, capacity=2048)
    kw.update(OPTIONS[option])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref, got = both(small_scene, **kw)
    check(ref, got)
    if option == "x0_trust":
        # the refine never leaves the L-inf ball around x0
        assert np.abs(got[0] - kw["x0"]).max() <= 0.5 + 1e-5
    if option == "no_overflow_refine":
        assert any("subsampled" in str(w.message) for w in caught)


def jax_patch_losses(scene, jobj, roi_size, img_size):
    """``params (R, 2) -> (R,)``: the JAX package's patch loss of every ROI
    of ``scene`` over its full window, as ``grid_cmax_batched`` forms it
    (default patch, blur 1.0), at any params."""
    bx, by, bt, bp, bm, org = jc.bucket_events_by_roi(
        *scene, img_size, roi_size, None)[:6]
    loss = jax.vmap(jc.make_patch_loss(
        jc.linvel_warp(), roi_size, jobj, patch=jc.PATCH_DEFAULT,
        blur_sigma=1.0, full_pixels=(img_size[0] + 1) * (img_size[1] + 1)))
    org = jnp.asarray(org, jnp.float32)
    return lambda params: np.asarray(
        loss(jnp.asarray(params), bx, by, bt, bp, bm, org))


def objectives_case(seed, obj):
    scene = flow_scene(np.random.default_rng(seed), 12.0, 6.0, 6000, (40, 60))
    jobj = {"adaptive_lifespan": J.models.variance_objective(
                adaptive_lifespan=True, minimum_events=105),
            "sos": J.models.sos_objective(),
            "zhu": J.models.zhu_timestamp_objective()}[obj]
    ref, got = both(scene, roi_size=(20, 20), img_size=(40, 60), maxiter=30,
                    obj=(jobj, objective_from_jax(jobj)))
    check(ref, got, truth=(12.0, 6.0),
          jax_loss=jax_patch_losses(scene, jobj, (20, 20), (40, 60)))
    return ref, got


@pytest.mark.parametrize("obj", ["adaptive_lifespan", "sos", "zhu"])
def test_grid_cmax_batched_objectives(obj):
    """The reference's own grid_cmax objective (adaptive lifespan, min 105
    events) and two other objectives through the batched solver, on a
    40x60 scene like that of the JAX tests.

    On this scene one ROI of the adaptive-lifespan solve lies between two
    basins: the port's f32 patch splat with exact patch-local coordinates
    lands 1.9 px/s from JAX's answer. The JAX patch loss itself must rate
    that answer no worse than JAX's own, and every other ROI must lie
    within ROI_ATOL."""
    ref, got = objectives_case(1, obj)
    if obj == "adaptive_lifespan":
        far = np.abs(got[0] - ref[0]).max(axis=1) > ROI_ATOL
        assert far.sum() <= 1


@pytest.mark.parametrize("obj", ["adaptive_lifespan", "sos", "zhu"])
def test_grid_cmax_batched_objectives_second_scene(obj):
    """The same on a second scene, where every ROI's answer is well
    conditioned: all ROIs within ROI_ATOL of JAX's."""
    ref, got = objectives_case(19, obj)
    np.testing.assert_allclose(got[0], ref[0], atol=ROI_ATOL)


def test_warm_refine_trust_and_unknown_options(small_scene):
    """make_roi_solve_one's refine variants: a static trust radius and the
    per-ROI ('traced') radius clamp the answer; an infinite radius recovers
    the flow from far away; bad options raise."""
    bx, by, bt, bp, bm, org, _ = pc.bucket_events_by_roi(
        *small_scene, SMALL, SMALL, 2048, device=CPU)
    args = (P.models.linvel_warp(), P.models.variance_objective(), SMALL,
            SMALL, 1.0, 30)
    x0 = torch.zeros((1, 2))
    p, _ = pc.make_roi_solve_one(*args, with_x0=True, trust_radius=2.0)(
        bx, by, bt, bp, bm, org.float(), x0)
    assert float(p.abs().max()) <= 2.0 + 1e-5
    traced = pc.make_roi_solve_one(*args, with_x0=True, trust_radius="traced")
    p, _ = traced(bx, by, bt, bp, bm, org.float(), x0, torch.full((1,), 3.0))
    assert float(p.abs().max()) <= 3.0 + 1e-5
    p, _ = traced(bx, by, bt, bp, bm, org.float(), x0,
                  torch.full((1,), torch.inf))
    np.testing.assert_allclose(p[0].numpy(), FLOW, atol=2.5)
    with pytest.raises(P.errors.ConfigurationError):
        pc.grid_cmax_batched(*small_scene, roi_size=(12, 16), img_size=SMALL,
                             smooth="boxcar", maxiter=2, device=CPU)
    with pytest.raises(P.errors.ConfigurationError):
        pc.make_roi_solve_one(*args, solver="newton")


def test_grid_cmax_batched_bfgs_solver(small_scene):
    """solver='bfgs': the port's BFGS per ROI, against JAX's vmapped BFGS."""
    kw = dict(roi_size=(12, 16), img_size=SMALL, maxiter=10, capacity=2048,
              solver="bfgs")
    ref, got = both(small_scene, **kw)
    check(ref, got)


def test_fit_global_motion_parity():
    """Translation scene: both fits recover the planted flow with near-zero
    divergence and rotation. The 80-step descent is chaotic in the last
    bits of the loss, so the two fits agree to 2 px/s and 1% in loss."""
    scene = flow_scene(np.random.default_rng(2), 18.0, -9.0, 6000, (40, 60))
    jp, jl = jc.fit_global_motion(*scene, (40, 60))
    pp, pl = pc.fit_global_motion(*scene, (40, 60), device=CPU)
    pp, jp = pp.numpy(), np.asarray(jp)
    assert pp.shape == (4,)
    np.testing.assert_allclose(pp[:2], [18.0, -9.0], atol=3.0)
    np.testing.assert_allclose(pp[:2], jp[:2], atol=2.0)
    assert abs(pp[2]) < 0.1 and abs(pp[3]) < 0.1
    assert abs(float(pl) - float(jl)) <= LOSS_REL * abs(float(jl))
    masked = np.ones(len(scene[0]), np.float32)
    masked[::3] = 0
    pm, _ = pc.fit_global_motion(*scene, (40, 60), mask=masked, maxiter=20,
                                 device=CPU)
    assert bool(torch.isfinite(pm).all())


def test_grid_cmax_host_loop_parity():
    """The host ROI loop over optimize_contrast: same ROIs, params within
    ROI_ATOL of the JAX loop, objective values within 1e-2."""
    scene = flow_scene(np.random.default_rng(4), 10.0, 5.0, 2000, (40, 60))
    jp, jr, jf = jc.grid_cmax(*scene, roi_size=(20, 30), img_size=(40, 60),
                              min_events=100)
    pp, pr, pf = pc.grid_cmax(*scene, roi_size=(20, 30), img_size=(40, 60),
                              min_events=100, device=CPU)
    assert pr == jr and len(pp) == len(jp) >= 1
    np.testing.assert_allclose(np.array(pp), np.array(jp), atol=ROI_ATOL)
    np.testing.assert_allclose(pf, jf, rtol=LOSS_REL)
    assert all(np.isfinite(p).all() for p in pp)
