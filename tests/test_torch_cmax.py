"""Parity of the PyTorch port's contrast maximisation against the JAX package.

Warps, objectives (loss values and analytic gradients), autograd losses,
grid searches, the BFGS port and both optimizers, on the CPU. Each port
warp/objective is built from its JAX twin through ``convert``.

Tolerances: f32 losses and images 1e-5 relative (gradients, which go
through more sums, 1e-4); final optimizer params within 0.5 px/s of the
JAX solve on a planted scene.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu_torch.convert import objective_from_jax, warp_from_jax

torch.set_num_threads(1)

CPU = "cpu"
SENSOR = (40, 60)
F32_REL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 0.5   # px/s


def assert_rel(got, ref, rel, floor=1e-6):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def scene(rng, vx=15.0, vy=-8.0, n_points=25, n_events=4000, t_max=1.0,
          sensor=SENSOR, noise=0.1):
    """Scene points moving with a planted velocity (vx, vy) px/s."""
    H, W = sensor
    mx = abs(vx) * t_max + 2
    my = abs(vy) * t_max + 2
    px = rng.uniform(mx if vx < 0 else 2, W - 2 - (mx if vx > 0 else 0),
                     n_points)
    py = rng.uniform(my if vy < 0 else 2, H - 2 - (my if vy > 0 else 0),
                     n_points)
    pol = rng.choice([-1.0, 1.0], n_points)
    idx = rng.integers(0, n_points, n_events)
    ts = np.sort(rng.uniform(0, t_max, n_events))
    xs = px[idx] + vx * ts + rng.normal(0, noise, n_events)
    ys = py[idx] + vy * ts + rng.normal(0, noise, n_events)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    f32 = lambda a: a[keep].astype(np.float32)
    return f32(xs), f32(ys), f32(ts), f32(pol[idx])


@pytest.fixture(scope="module")
def ev():
    return scene(np.random.default_rng(3), n_events=2500)


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linvel_warp", "xyztheta_warp",
                                  "pure_rotation_warp"])
def test_warp_and_jacobian_parity(ev, name):
    xs, ys, ts, ps = ev
    jw = J.models.get_warp(name)
    pw = warp_from_jax(jw)
    assert type(pw).__name__ == name and pw.dims == jw.dims
    params = np.linspace(0.3, 1.7, jw.dims).astype(np.float32) * 3
    t0 = float(ts[-1])
    r = jw.warp(xs, ys, ts, ps, t0, params, compute_grad=True)
    g = pw.warp(xs, ys, ts, ps, t0, params, compute_grad=True, device=CPU)
    for a, b in zip(g, r):
        assert_rel(a, np.asarray(b), F32_REL, floor=1.0)


def test_registries_and_errors():
    assert set(P.models.WARP_REGISTRY) == set(J.models.WARP_REGISTRY)
    assert set(P.models.OBJECTIVE_REGISTRY) == set(
        J.models.OBJECTIVE_REGISTRY)
    with pytest.raises(P.errors.RegistryError):
        P.models.get_warp("affine")
    with pytest.raises(P.errors.RegistryError):
        P.models.get_objective("entropy")
    assert P.models.get_objective("isoa", thresh=0.7).thresh == 0.7


# ---------------------------------------------------------------------------
# IWE and objectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "matmul"])
def test_get_iwe_parity(ev, impl):
    xs, ys, ts, ps = ev
    mask = np.ones(len(xs), np.float32)
    mask[-40:] = 0
    params = np.array([14.0, -7.0], np.float32)
    r = J.models.get_iwe(params, xs, ys, ts, ps, J.models.linvel_warp(),
                         SENSOR, compute_gradient=True, return_events=True,
                         return_per_event_contrast=True, mask=mask, impl=impl)
    g = P.models.get_iwe(params, xs, ys, ts, ps, P.models.linvel_warp(),
                         SENSOR, compute_gradient=True, return_events=True,
                         return_per_event_contrast=True, mask=mask, impl=impl,
                         device=CPU)
    rel = 3e-5 if impl else F32_REL
    assert_rel(g[0], np.asarray(r[0]), rel, floor=1.0)
    assert_rel(g[1], np.asarray(r[1]), rel, floor=1.0)
    assert_rel(g[2][0], np.asarray(r[2][0]), F32_REL, floor=1.0)
    assert_rel(g[3], np.asarray(r[3]), rel, floor=1.0)


def test_iwe_validity_mask_is_open_interval():
    x = torch.tensor([0.0, 0.5, 59.9, 60.0, 3.0])
    y = torch.tensor([3.0, 3.0, 3.0, 3.0, 40.0])
    assert P.models.iwe_validity_mask(x, y, SENSOR).tolist() == [
        False, True, True, False, False]


OBJECTIVES = [("variance", {}), ("rms", {}), ("sos", {}), ("soe", {}),
              ("moa", {}), ("isoa", {"thresh": 0.4}), ("sosa", {"p": 2}),
              ("zhu", {}), ("r1", {"p": 2})]


@pytest.mark.parametrize("name,kw", OBJECTIVES)
def test_objective_value_and_analytic_gradient(ev, name, kw):
    xs, ys, ts, ps = ev
    jobj = J.models.get_objective(name, **kw)
    pobj = objective_from_jax(jobj)
    assert type(pobj).__name__ == type(jobj).__name__
    params = np.array([13.0, -6.0], np.float32)
    args = (params, xs, ys, ts, ps)
    jf = jobj.evaluate_function(*args, J.models.linvel_warp(), SENSOR)
    pf = pobj.evaluate_function(*args, P.models.linvel_warp(), SENSOR,
                                device=CPU)
    assert abs(pf - jf) <= F32_REL * max(abs(jf), 1.0) * 10, (pf, jf)
    jg = jobj.evaluate_gradient(*args, J.models.linvel_warp(), SENSOR)
    pg = pobj.evaluate_gradient(*args, P.models.linvel_warp(), SENSOR,
                                device=CPU)
    if jg is None:
        assert pg is None
    else:
        assert_rel(pg, jg, GRAD_REL)
        # the kernel route of the analytic gradient (plain version on CPU)
        pk = pobj.evaluate_gradient(*args, P.models.linvel_warp(), SENSOR,
                                    impl="matmul", device=CPU)
        assert_rel(pk, jg, GRAD_REL)


@pytest.mark.parametrize("name", ["variance", "zhu", "isoa", "sosa"])
def test_autograd_loss_matches_jax_grad(ev, name):
    xs, ys, ts, ps = ev
    jobj = J.models.get_objective(name)
    pobj = objective_from_jax(jobj)
    jl = J.contrast_max.make_objective_loss(jobj, J.models.linvel_warp(),
                                            SENSOR, 1.0, iwe_impl="matmul")
    pl = P.contrast_max.make_objective_loss(pobj, P.models.linvel_warp(),
                                            SENSOR, 1.0, iwe_impl="matmul")
    p0 = np.array([12.0, -5.0], np.float32)
    jv, jgr = jax.value_and_grad(
        lambda p: jl(p, xs, ys, ts, ps))(jnp.asarray(p0))
    pt = torch.tensor(p0, requires_grad=True)
    t = lambda a: torch.as_tensor(a)
    pv = pl(pt, t(xs), t(ys), t(ts), t(ps))
    (pgr,) = torch.autograd.grad(pv, pt)
    assert abs(float(pv.detach()) - float(jv)) <= 3e-5 * max(abs(float(jv)), 1.0)
    assert_rel(pgr, np.asarray(jgr), 1e-3)


def test_adaptive_lifespan_objective_and_mask(ev):
    xs, ys, ts, ps = ev
    jobj = J.models.variance_objective(adaptive_lifespan=True,
                                       minimum_events=500)
    pobj = objective_from_jax(jobj)
    assert pobj.adaptive_lifespan and pobj.minimum_events == 500
    for o in (jobj, pobj):
        o.iter_update(np.array([20.0, -10.0]))
    args = (np.array([15.0, -8.0], np.float32), xs, ys, ts, ps)
    jf = jobj.evaluate_function(*args, J.models.linvel_warp(), SENSOR)
    pf = pobj.evaluate_function(*args, P.models.linvel_warp(), SENSOR,
                                device=CPU)
    assert pobj.s_idx == jobj.s_idx
    assert abs(pf - jf) <= 1e-4 * abs(jf)
    jm = np.asarray(J.utils.lifespan_mask(ts, np.array([20.0, -10.0]), 5,
                                          500))
    pm = P.utils.lifespan_mask(ts, np.array([20.0, -10.0]), 5, 500,
                               device=CPU)
    assert np.array_equal(pm.numpy(), jm)


def test_event_util_parity(ev, rng):
    xs, ys, ts, ps = ev
    assert P.utils.infer_resolution(xs, ys) == J.utils.infer_resolution(
        xs, ys)
    jm = np.asarray(J.utils.events_bounds_mask(xs, ys, 5, 50, 3, 30))
    pm = P.utils.events_bounds_mask(xs, ys, 5, 50, 3, 30, device=CPU)
    assert np.array_equal(pm.numpy(), jm)
    jc = J.utils.clip_events_to_bounds(xs, ys, ts, ps, [30, 50])
    pc = P.utils.clip_events_to_bounds(xs, ys, ts, ps, [30, 50])
    for a, b in zip(pc, jc):
        assert np.array_equal(a, np.asarray(b))
    jz = J.utils.clip_events_to_bounds(xs, ys, ts, ps, [2, 30, 4, 50],
                                       set_zero=True)
    pz = P.utils.clip_events_to_bounds(xs, ys, ts, ps, [2, 30, 4, 50],
                                       set_zero=True, device=CPU)
    for a, b in zip(pz, jz):
        assert_rel(a, np.asarray(b), F32_REL, floor=1.0)
    for side in ("back", "front"):
        jl = J.utils.cut_events_to_lifespan(xs, ys, ts, ps, [10.0, 3.0], 2,
                                            100, side=side)
        pl = P.utils.cut_events_to_lifespan(xs, ys, ts, ps, [10.0, 3.0], 2,
                                            100, side=side)
        assert all(np.array_equal(a, b) for a, b in zip(pl, jl))
    with pytest.raises(P.errors.ConfigurationError):
        P.utils.cut_events_to_lifespan(xs, ys, ts, ps, [1.0], 2, side="mid")
    assert P.utils.binary_search_array(ts, 0.5) == J.utils.binary_search_array(
        ts, 0.5)
    assert (P.utils.binary_search_torch_tensor(ts, 0, len(ts) - 1, 0.3)
            == J.utils.binary_search_torch_tensor(ts, 0, len(ts) - 1, 0.3))
    ix = rng.integers(0, 60, 3000)
    iy = rng.integers(0, 40, 3000)
    hot = (ix < 3) & (iy < 3)
    jr = J.utils.remove_hot_pixels(ix, iy, ix * 0.0, np.ones(3000), SENSOR, 4)
    pr = P.utils.remove_hot_pixels(ix, iy, ix * 0.0, np.ones(3000), SENSOR, 4,
                                   device=CPU)
    assert all(np.array_equal(a, b) for a, b in zip(pr, jr))
    assert hot.any()


# ---------------------------------------------------------------------------
# Grid search, BFGS and the optimizers
# ---------------------------------------------------------------------------

def test_grid_search_initial_and_optimisation_parity(ev):
    xs, ys, ts, ps = ev
    jobj = J.models.variance_objective()
    pobj = objective_from_jax(jobj)
    ji = J.contrast_max.grid_search_initial(xs, ys, ts, ps,
                                            J.models.linvel_warp(), jobj,
                                            SENSOR)
    pi = P.contrast_max.grid_search_initial(xs, ys, ts, ps,
                                            P.models.linvel_warp(), pobj,
                                            SENSOR, device=CPU)
    assert_rel(np.array(pi["eval"]), np.array(ji["eval"]), 3e-5)
    assert np.array_equal(pi["min_params"], ji["min_params"])
    jo = J.contrast_max.grid_search_optimisation(
        xs, ys, ts, ps, J.models.linvel_warp(), jobj, SENSOR,
        log_scale=False, max_iters=6)
    po = P.contrast_max.grid_search_optimisation(
        xs, ys, ts, ps, P.models.linvel_warp(), pobj, SENSOR,
        log_scale=False, max_iters=6, device=CPU)
    np.testing.assert_allclose(po["min_params"], jo["min_params"],
                               atol=PARAM_ATOL)


def test_grid_search_refine_parity(ev):
    xs, ys, ts, ps = ev
    jl = J.contrast_max.make_objective_loss(J.models.variance_objective(),
                                            J.models.linvel_warp(), SENSOR,
                                            1.0)
    pl = P.contrast_max.make_objective_loss(P.models.variance_objective(),
                                            P.models.linvel_warp(), SENSOR,
                                            1.0)
    jp, je = jax.jit(lambda: J.contrast_max.grid_search_refine(
        lambda p: jl(p, xs, ys, ts, ps), 2, iters=6))()
    t = lambda a: torch.as_tensor(a)
    pp, pe = P.contrast_max.grid_search_refine(
        lambda p: pl(p, t(xs), t(ys), t(ts), t(ps)), 2, iters=6, device=CPU)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=PARAM_ATOL)
    assert abs(float(pe) - float(je)) <= 3e-5 * abs(float(je))


@pytest.mark.parametrize("fn,maxiter", [("rosen", 10), ("bowl", 100)])
def test_bfgs_port_walks_jax_path(fn, maxiter):
    """The torch BFGS takes JAX's steps: same iterates (to f32 rounding),
    iteration and evaluation counts, and status. Rosenbrock is cut at 10
    iterations: its f32 solve is chaotic later, in both solvers."""
    from jax.scipy.optimize import minimize
    from event_utils_tpu_torch.contrast_max.bfgs import minimize_bfgs

    def f(x, lib):
        if fn == "rosen":
            return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                           + (1 - x[:-1]) ** 2)
        return lib.sum((x - 1.5) ** 2 * lib.exp(0.3 * x)) + 0.1 * x[0] ** 4

    x0 = np.array([-1.2, 1.0, 0.7], np.float32)
    jr = minimize(lambda x: f(x, jnp), jnp.asarray(x0), method="BFGS",
                  options={"maxiter": maxiter, "gtol": 1e-6})

    def vg(x):
        x = x.detach().requires_grad_(True)
        v = f(x, torch)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    pr = minimize_bfgs(vg, torch.as_tensor(x0), maxiter=maxiter, gtol=1e-6)
    np.testing.assert_allclose(pr.x_k.numpy(), np.asarray(jr.x), atol=1e-4)
    assert (pr.k, pr.nfev, pr.status) == (int(jr.nit), int(jr.nfev),
                                          int(jr.status))


@pytest.mark.parametrize("grid_init", [True, False])
def test_optimize_contrast_jit_parity(ev, grid_init):
    xs, ys, ts, ps = ev
    jobj = J.models.variance_objective()
    kw = dict(img_size=SENSOR, grid_search_init=grid_init)
    if not grid_init:
        kw["x0"] = np.array([10.0, -4.0], np.float32)
    jp = np.asarray(J.contrast_max.optimize_contrast_jit(
        xs, ys, ts, ps, J.models.linvel_warp(), jobj, **kw))
    pp = P.contrast_max.optimize_contrast_jit(
        xs, ys, ts, ps, P.models.linvel_warp(), objective_from_jax(jobj),
        device=CPU, **kw)
    np.testing.assert_allclose(pp.numpy(), jp, atol=PARAM_ATOL)
    np.testing.assert_allclose(pp.numpy(), [15.0, -8.0], atol=3.0)


def test_optimize_contrast_jit_masked_zhu(ev):
    """Collapse-prone objective: capped init range, masked batch."""
    xs, ys, ts, ps = ev
    mask = np.ones(len(xs), np.float32)
    mask[::5] = 0
    jobj = J.models.zhu_timestamp_objective()
    jp = np.asarray(J.contrast_max.optimize_contrast_jit(
        xs, ys, ts, ps, J.models.linvel_warp(), jobj, img_size=SENSOR,
        mask=mask, grid_search_init=True, maxiter=20))
    pp = P.contrast_max.optimize_contrast_jit(
        xs, ys, ts, ps, P.models.linvel_warp(), objective_from_jax(jobj),
        img_size=SENSOR, mask=mask, grid_search_init=True, maxiter=20,
        device=CPU)
    np.testing.assert_allclose(pp.numpy(), jp, atol=PARAM_ATOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_optimize_contrast_parity(ev, adaptive):
    xs, ys, ts, ps = ev
    jobj = J.models.variance_objective(adaptive_lifespan=adaptive,
                                       minimum_events=800)
    kw = dict(blur_sigma=1.0, img_size=SENSOR, grid_search_init=True)
    jp = J.contrast_max.optimize_contrast(xs, ys, ts, ps,
                                          J.models.linvel_warp(), jobj, **kw)
    pobj = objective_from_jax(J.models.variance_objective(
        adaptive_lifespan=adaptive, minimum_events=800))
    pp = P.contrast_max.optimize_contrast(xs, ys, ts, ps,
                                          P.models.linvel_warp(), pobj,
                                          device=CPU, **kw)
    np.testing.assert_allclose(pp, jp, atol=PARAM_ATOL)
    np.testing.assert_allclose(pp, [15.0, -8.0], atol=3.0)


def test_optimize_and_optimize_r2_run(ev):
    xs, ys, ts, ps = ev
    x0 = np.array([14.0, -7.0])
    a = P.contrast_max.optimize_contrast(
        xs, ys, ts, ps, P.models.linvel_warp(), P.models.sos_objective(),
        x0=x0, numeric_grads=True, blur_sigma=1.0, img_size=SENSOR,
        device=CPU)
    b = J.contrast_max.optimize_contrast(
        xs, ys, ts, ps, J.models.linvel_warp(), J.models.sos_objective(),
        x0=x0, numeric_grads=True, blur_sigma=1.0, img_size=SENSOR)
    np.testing.assert_allclose(a, b, atol=PARAM_ATOL)
    r2 = P.contrast_max.optimize_r2(xs, ys, ts, ps, P.models.linvel_warp(),
                                    P.models.variance_objective(),
                                    numeric_grads=False, img_size=SENSOR,
                                    device=CPU)
    assert np.all(np.isfinite(r2)) and r2.shape == (2,)
