"""Parity of the port's batched solves against the JAX package, on the CPU.

Where JAX runs a function under ``jax.vmap`` (the grid searches' and the
landscape's parameter samples, the ROI solvers' BFGS and full-frame loss),
the port writes the sample axis out: the batched bilinear splat
(``jax.vmap`` of ``bilinear_matmul``, the Pallas kernel with a grid axis
added), ``make_objective_loss`` at (S, dims) samples, and a BFGS whose rows walk their
own paths (``jax.vmap`` of ``jax.scipy.optimize.minimize``). The same numpy
inputs from a seed go through both packages; the Pallas kernel runs in
interpret mode and the port's kernel wrappers run their plain versions for
CPU tensors.

Tolerances (relative to the output's max |value| unless said otherwise):
- the batched splat's plain version against S single plain splats:
  bitwise (the same f32 products, each image summed in the same order);
- against JAX's vmapped Pallas kernel in interpret mode: 1e-5 (the hilo
  class);
- its gradients against the per-sample gather VJP: 1e-6;
- batched losses against the per-sample loop: 1e-6 (a vectorised reduction
  sums in another order), their per-sample gradients 1e-5 (more sums);
- ``grid_search_initial``'s losses against JAX's: 1e-5, the same argmin;
- the landscape against JAX's ``draw_objective_function``: 1e-5 of its
  [0, 1] range, the same peak;
- batched BFGS rows against single-row solves: x to 1e-5, the same
  iterations, evaluations and status; against ``jax.vmap(minimize)``: the
  same iterations, x to 1e-4 (not the status: where a row's gradient ends
  at the f32 noise floor of its loss, near ``gtol``, its last line search
  can fail in one package and stop in the other);
- the ROI solvers: ``test_torch_roi_solvers``' rule (1.5 px/s per ROI, 0.5
  for the median).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.contrast_max import bfgs as pbfgs
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.convert import objective_from_jax
from event_utils_tpu_torch.ops import cuda_scatter as cs
from test_torch_roi import flow_scene
from test_torch_roi_solvers import FLOW, SMALL, both, check

torch.set_num_threads(1)

CPU = "cpu"
SENSOR = (40, 60)
HILO_REL = 1e-5
VJP_REL = 1e-6
LOOP_REL = 1e-6
JAX_LOSS_REL = 1e-5
X_SINGLE = 1e-5
X_JAX = 1e-4
OBJECTIVES = ["variance", "rms", "sos", "soe", "moa", "isoa", "sosa", "zhu",
              "r1"]


def assert_rel(got, ref, rel, floor=1e-6):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture(scope="module")
def scene():
    """A 40x60 scene moving at (15, -8) px/s, float32."""
    xs, ys, ts, ps = flow_scene(np.random.default_rng(3), 15.0, -8.0, 3000,
                                SENSOR)
    return tuple(a.astype(np.float32) for a in (xs, ys, ts, ps))


def coords(rng, S, n, H, W, odd=True):
    """(S, n) coordinates over and around an (H, W) image; with ``odd``,
    NaN, +-inf and huge values in sample 0 and sample 1 wholly off the
    image."""
    x = rng.uniform(-2, W + 1, (S, n)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (S, n)).astype(np.float32)
    if odd:
        x[0, ::7] = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, W, -1.5],
                             np.float32)[np.arange(len(x[0, ::7])) % 7]
        y[0, 3::11] = np.nan
        x[1] = -50.0
    return torch.as_tensor(x), torch.as_tensor(y)


# ---------------------------------------------------------------------------
# The batched splat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,shared", [(1, True), (1, False), (4, True),
                                      (4, False)])
def test_batched_plain_equals_single_plain_calls(rng, K, shared):
    S, n, H, W = 5, 700, 21, 33
    x, y = coords(rng, S, n, H, W)
    shape = (K, n) if shared else (S, K, n)
    w = torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32))
    got = cs.bilinear_scatter_batched_plain(x, y, w, H, W)
    ref = torch.stack([cs.bilinear_scatter_plain(
        x[s], y[s], w if shared else w[s], H, W) for s in range(S)])
    assert got.shape == (S, K, H, W)
    assert torch.equal(got, ref)
    assert float(got[1].abs().max()) == 0.0      # a sample wholly off
    assert torch.equal(cs.bilinear_scatter_batched(x, y, w, H, W), got)


@pytest.mark.parametrize("K,shared", [(1, True), (4, False)])
def test_batched_splat_matches_jax_vmap(rng, K, shared):
    """jax.vmap of the Pallas kernel (interpret mode) over the samples."""
    S, n, H, W = 3, 1500, 41, 61
    x, y = coords(rng, S, n, H, W, odd=False)
    w = rng.normal(0, 1, (K, n) if shared else (S, K, n)).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)

    def one(xs, ys, ws):
        return jps.bilinear_matmul(xs, ys, ws[0] if K == 1 else ws, (H, W),
                                   mask=mask, chunk=1024, interpret=True)

    ref = jax.vmap(one, in_axes=(0, 0, None if shared else 0))(
        x.numpy(), y.numpy(), w)
    got = cs.bilinear_matmul_batched(x, y, torch.as_tensor(w), (H, W),
                                     mask=torch.as_tensor(mask))
    assert_rel(got[:, 0] if K == 1 else got, np.asarray(ref), HILO_REL)


@pytest.mark.parametrize("shared", [True, False])
def test_batched_splat_gradient_is_per_sample_vjp(rng, shared):
    S, n, H, W, K = 4, 900, 31, 45, 2
    x, y = coords(rng, S, n, H, W, odd=False)
    w = torch.as_tensor(rng.normal(0, 1, (K, n) if shared else (S, K, n))
                        .astype(np.float32))
    tgt = torch.as_tensor(rng.normal(0, 1, (S, K, H, W)).astype(np.float32))
    xg, yg, wg = (a.clone().requires_grad_(True) for a in (x, y, w))
    loss = (cs.bilinear_matmul_batched(xg, yg, wg, (H, W)) * tgt).sum()
    got = torch.autograd.grad(loss, (xg, yg, wg))
    refs = []
    for s in range(S):
        a, b = x[s].clone().requires_grad_(True), y[s].clone()
        b.requires_grad_(True)
        c = (w if shared else w[s]).clone().requires_grad_(True)
        one = (cs.bilinear_matmul(a, b, c, (H, W)) * tgt[s]).sum()
        refs.append(torch.autograd.grad(one, (a, b, c)))
    ref_w = (sum(r[2] for r in refs) if shared
             else torch.stack([r[2] for r in refs]))
    for g, r in zip(got, (torch.stack([r[0] for r in refs]),
                          torch.stack([r[1] for r in refs]), ref_w)):
        assert_rel(g, r, VJP_REL)


def test_batched_splat_routes_and_checks(rng):
    x, y = coords(rng, 2, 50, 181, 241, odd=False)
    assert cs.bilinear_batched_route(1, 181, 241, 50, 2) == "private"
    # one image of few events (S = 1): the direct route, as it measured
    assert cs.bilinear_batched_route(1, 181, 241, 50) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 200_000) == "vector"
    w4 = torch.ones(4, 50)
    with pytest.raises(P.errors.ConfigurationError):   # K=4 past 227 KB
        cs.bilinear_scatter_batched(x, y, w4, 181, 241, route="private")
    with pytest.raises(P.errors.ConfigurationError):   # w (S', K, N)
        cs.bilinear_scatter_batched(x, y, torch.ones(3, 1, 50), 181, 241)
    with pytest.raises(P.errors.ConfigurationError):   # x must be (S, N)
        cs.bilinear_scatter_batched(x[0], y[0], w4, 181, 241)
    assert cs.BATCH_MAX_SAMPLES == 65535      # the grid's y extent
    # the loss's chunks: the slots bind at 200k events, the images at VGA
    assert pc.batch_chunk(200_000, (180, 240)) == (
        pc.BATCH_MAX_SLOTS // 200_000) == 83
    assert pc.batch_chunk(2048, (480, 640)) == (
        pc.BATCH_MAX_IMAGE_BYTES // (16 * 481 * 641)) == 217
    assert pc.batch_chunk(0, (1, 1)) == pc.BATCH_MAX_SLOTS
    assert pc.batch_chunk(1 << 30, (720, 1280)) == 1
    assert "bilinear_scatter_batched:private" in cs.ROUTES
    assert "bilinear_scatter_batched:direct" in cs.KERNEL_WRAPPERS


@pytest.mark.parametrize("impl", ["xla", "sort", "matmul", "pallas"])
def test_sample_coordinates_dispatch_by_impl(rng, impl):
    """ops.bilinear_scatter with (S, N) coordinates: every impl gives the
    S single splats; (N,) and (S, N) weights and masks."""
    S, n, H, W = 4, 600, 19, 27
    x, y = coords(rng, S, n, H, W)
    w = torch.as_tensor(rng.normal(0, 1, n).astype(np.float32))
    m = torch.as_tensor(rng.random((S, n)) > 0.3)
    got = P.ops.bilinear_scatter(x, y, w, (H, W), mask=m, impl=impl)
    ref = torch.stack([P.ops.bilinear_scatter(x[s], y[s], w, (H, W),
                                              mask=m[s], impl="xla")
                       for s in range(S)])
    assert got.shape == (S, H, W)
    assert_rel(got, ref, LOOP_REL)


# ---------------------------------------------------------------------------
# Warps, images and the batched loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warp", ["linvel", "xyztheta", "pure_rotation"])
def test_warps_broadcast_over_samples(rng, warp):
    wf = P.models.get_warp(warp)
    n, S = 300, 6
    xs, ys = (torch.as_tensor(rng.uniform(0, 60, n).astype(np.float32))
              for _ in range(2))
    ts = torch.as_tensor(np.sort(rng.uniform(0, 1, n)).astype(np.float32))
    params = torch.as_tensor(rng.normal(0, 3, (S, wf.dims))
                             .astype(np.float32))
    xw, yw = wf.warp_fn(params, xs, ys, ts, ts[-1])
    for s in range(S):
        rx, ry = wf.warp_fn(params[s], xs, ys, ts, ts[-1])
        assert torch.equal(xw[s], rx) and torch.equal(yw[s], ry)


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_timestamp_images_over_samples(scene, impl):
    xs, ys, ts, ps = (torch.as_tensor(a) for a in scene)
    S = 4
    shift = torch.arange(S, dtype=torch.float32)[:, None] * 3.0 - 4.0
    xw, yw = xs + shift, ys - 0.5 * shift
    valid = (xw > 0) & (xw < SENSOR[1]) & (yw > 0) & (yw < SENSOR[0])
    pos, neg = P.representations.events_to_timestamp_image(
        xw, yw, ts, ps, SENSOR, mask=valid, impl=impl)
    for s in range(S):
        rp, rn = P.representations.events_to_timestamp_image(
            xw[s], yw[s], ts, ps, SENSOR, mask=valid[s], impl=impl)
        assert_rel(pos[s], rp, LOOP_REL)
        assert_rel(neg[s], rn, LOOP_REL)


def samples_grid(S=12, seed=5):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -30, 30, (S, 2)).astype(np.float32))


@pytest.mark.parametrize("name", OBJECTIVES)
def test_batched_loss_equals_per_sample_loop(scene, name):
    """Every objective's batched loss (values and per-sample gradients)
    against the per-sample loop over ``make_objective_loss``."""
    obj = P.models.get_objective(name)
    ev = tuple(torch.as_tensor(a) for a in scene)
    mask = torch.as_tensor((np.arange(len(scene[0])) % 5 != 0)
                           .astype(np.float32))
    args = (obj, P.models.linvel_warp(), SENSOR, 1.0)
    loss = pc.make_objective_loss(*args, iwe_impl="matmul")
    Pm = samples_grid().requires_grad_(True)
    got = loss(Pm, *ev, mask)
    (g,) = torch.autograd.grad(got.sum(), Pm)
    ref, ref_g = [], []
    for p in Pm.detach():
        p = p.clone().requires_grad_(True)
        v = loss(p, *ev, mask)
        ref.append(v.detach())
        ref_g.append(torch.autograd.grad(v, p)[0])
    assert got.shape == (Pm.shape[0],)
    assert_rel(got, torch.stack(ref), LOOP_REL)
    assert_rel(g, torch.stack(ref_g), 1e-5)


@pytest.mark.parametrize("name", ["variance", "zhu"])
def test_batched_loss_rows_and_chunks(scene, monkeypatch, name):
    """Events as one row per sample (the ROI solvers' full-frame loss) and
    a batch split into chunks of ``batch_chunk`` samples give the per-sample
    losses."""
    obj = P.models.get_objective(name)
    loss = pc.make_objective_loss(obj, P.models.linvel_warp(), SENSOR, 1.0,
                                  iwe_impl="matmul")
    rng = np.random.default_rng(2)
    n = 800
    rows = [np.sort(rng.choice(len(scene[0]), n, replace=False))
            for _ in range(5)]     # sorted ids keep each row time-sorted
    ev = [torch.as_tensor(np.stack([a[r] for r in rows])) for a in scene]
    mask = torch.as_tensor(rng.random((5, n)) > 0.2).float()
    Pm = samples_grid(5)
    ref = torch.stack([loss(Pm[s], *(a[s] for a in ev), mask[s])
                       for s in range(5)])
    assert_rel(loss(Pm, *ev, mask), ref, LOOP_REL)
    whole = loss(samples_grid(12), *(torch.as_tensor(a) for a in scene))
    monkeypatch.setattr(pc, "BATCH_MAX_SLOTS", 2 * n)
    assert pc.batch_chunk(n, SENSOR) == 2
    assert pc.batch_chunk(len(scene[0]), SENSOR) == 1
    assert_rel(loss(Pm, *ev, mask), ref, LOOP_REL)     # rows in 3 chunks
    parts = loss(samples_grid(12), *(torch.as_tensor(a) for a in scene))
    assert torch.equal(parts, whole)


# ---------------------------------------------------------------------------
# Grid searches and the landscape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["variance", "sos", "zhu"])
def test_grid_search_initial_matches_jax(scene, name):
    jobj = J.models.get_objective(name)
    kw = dict(log_scale=False, param_ranges=[[-40, 40], [-40, 40]])
    jr = J.contrast_max.grid_search_initial(*scene, J.models.linvel_warp(),
                                            jobj, SENSOR, **kw)
    pr = P.contrast_max.grid_search_initial(*scene, P.models.linvel_warp(),
                                            objective_from_jax(jobj), SENSOR,
                                            device=CPU, **kw)
    assert_rel(np.array(pr["eval"]), np.array(jr["eval"]), JAX_LOSS_REL)
    np.testing.assert_array_equal(pr["min_params"], jr["min_params"])


def test_grid_search_initial_equals_per_sample_loop(scene):
    obj = P.models.variance_objective()
    pr = P.contrast_max.grid_search_initial(*scene, P.models.linvel_warp(),
                                            obj, SENSOR, device=CPU)
    loss = pc.make_objective_loss(obj, P.models.linvel_warp(), SENSOR, 1.0,
                                  iwe_impl="matmul")
    ev = tuple(torch.as_tensor(a) for a in scene)
    ref = [float(loss(torch.as_tensor(np.float32(c)), *ev))
           for c in pr["params"]]
    assert_rel(np.array(pr["eval"]), np.array(ref), LOOP_REL)


def test_grid_search_refine_equals_per_sample_loop(scene):
    """The refine's levels evaluated as one batched loss against the loop
    over samples this port ran before (kept here only)."""
    ev = tuple(torch.as_tensor(a) for a in scene)
    args = (P.models.variance_objective(), P.models.linvel_warp(), SENSOR,
            1.0)
    loss = pc.make_objective_loss(*args, iwe_impl="matmul")
    bp, be = pc.grid_search_refine(lambda Pm: loss(Pm, *ev), 2, iters=6,
                                   device=CPU)
    lp, le = pc.grid_search_refine_batched(
        lambda c: torch.stack([loss(p, *ev) for p in c[0]])[None], 2,
        torch.full((1,), 150.0), iters=6)
    np.testing.assert_allclose(bp.numpy(), lp[0].numpy(), atol=1e-4)
    assert_rel(be, le[0], LOOP_REL)


def test_grid_search_argmin_keeps_the_first_minimum():
    """Equal losses: the first sample wins, as jnp.argmin picks it."""
    bp, be = pc.grid_search_refine(
        lambda Pm: torch.zeros(Pm.shape[0]), 2, init_range=10.0, iters=1,
        device=CPU)
    jp, _ = jc.grid_search_refine(lambda p: jnp.float32(0.0), 2,
                                  init_range=10.0, iters=1)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jp))
    assert bp.tolist() == [-10.0, -10.0] and float(be) == 0.0


def test_optimize_contrast_jit_grid_init_matches_jax(scene):
    jobj = J.models.variance_objective()
    jp = np.asarray(J.contrast_max.optimize_contrast_jit(
        *scene, J.models.linvel_warp(), jobj, img_size=SENSOR,
        grid_search_init=True))
    pp = P.contrast_max.optimize_contrast_jit(
        *scene, P.models.linvel_warp(), objective_from_jax(jobj),
        img_size=SENSOR, grid_search_init=True, device=CPU)
    assert pp.device.type == "cpu"
    np.testing.assert_allclose(pp.numpy(), jp, atol=0.5)


def test_landscape_matches_jax_draw_objective_function(scene):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kw = dict(x_range=(-60, 60), y_range=(-40, 40), resolution=8,
              img_size=SENSOR)
    ref = jc.draw_objective_function(*scene, gt=(15, -8), show=False, **kw)
    plt.close("all")
    got = pc._objective_landscape(
        *scene, P.models.variance_objective(minimum_events=1),
        P.models.linvel_warp(), device=CPU, **kw).numpy()
    assert got.shape == ref.shape == (10, 15)
    np.testing.assert_allclose(got, ref, atol=JAX_LOSS_REL)
    assert np.argmax(got) == np.argmax(ref)
    loop = pc.make_objective_loss(
        P.models.variance_objective(minimum_events=1), P.models.linvel_warp(),
        SENSOR, 0.0, iwe_impl="matmul")
    ev = tuple(torch.as_tensor(a) for a in scene)
    vys, vxs = np.meshgrid(np.arange(10), np.arange(15), indexing="ij")
    raw = -torch.stack([loop(torch.tensor([vx * 8.0 - 60, vy * 8.0 - 40]),
                             *ev) for vx, vy in zip(vxs.ravel(),
                                                    vys.ravel())])
    raw = raw.reshape(10, 15)
    raw = (raw - raw.min()) / ((raw.max() - raw.min()) + 1e-6)
    np.testing.assert_allclose(got, raw.numpy(), atol=LOOP_REL)


# ---------------------------------------------------------------------------
# The batched BFGS
# ---------------------------------------------------------------------------

# Row problems f_r(x) = sum_d a_r (x_d - c_rd)^2 exp(b_r x_d) + q_r x_0^4:
# bowls of different shapes, so the rows take different numbers of
# iterations; row 0 starts at its minimum (zero gradient) and converges at
# iteration 0.
A = np.float32([1.0, 1.0, 0.5, 3.0, 0.2, 1.0])
BE = np.float32([0.0, 0.3, -0.4, 0.1, 0.5, 0.8])
CE = np.float32([[0.0, 0.0, 0.0], [1.5, 1.5, 1.5], [-1.0, 2.0, 0.5],
                 [0.3, -0.7, 2.0], [2.0, 1.0, -1.0], [-0.5, 0.5, 1.0]])
QE = np.float32([0.1, 0.1, 0.0, 0.3, 0.05, 0.2])
X0 = np.float32([[0.0, 0.0, 0.0], [-1.2, 1.0, 0.7], [0.5, 0.5, 0.5],
                 [2.0, -1.0, 0.0], [-2.0, 0.3, 1.1], [1.0, 1.0, -1.0]])


def bowl(x, a, b, c, q, lib):
    return (lib.sum(a[..., None] * (x - c) ** 2 * lib.exp(b[..., None] * x),
                    -1) + q * x[..., 0] ** 4)


def rows_vg(rows=slice(None)):
    consts = [torch.as_tensor(v[rows]) for v in (A, BE, CE, QE)]

    def vg(X):
        X = X.detach().requires_grad_(True)
        f = bowl(X, *consts, torch)
        (g,) = torch.autograd.grad(f.sum(), X)
        return f.detach(), g

    return vg


def test_batched_bfgs_rows_equal_single_row_solves():
    res = pbfgs.minimize_bfgs(rows_vg(), torch.as_tensor(X0), maxiter=100,
                              gtol=1e-6)
    assert int(res.k[0]) == 0 and bool(res.converged[0])
    assert len(set(res.k.tolist())) >= 3          # mixed iteration counts
    for r in range(len(X0)):
        vg_r = rows_vg(slice(r, r + 1))

        def vg_one(x, vg_r=vg_r):
            f, g = vg_r(x[None])
            return f[0], g[0]

        one = pbfgs.minimize_bfgs(vg_one, torch.as_tensor(X0[r]),
                                  maxiter=100, gtol=1e-6)
        np.testing.assert_allclose(res.x_k[r].numpy(), one.x_k.numpy(),
                                   atol=X_SINGLE)
        assert (int(res.k[r]), int(res.nfev[r]), int(res.status[r])) == (
            one.k, one.nfev, one.status)


def test_batched_bfgs_matches_jax_vmapped_minimize():
    from jax.scipy.optimize import minimize

    def solve(x0, a, b, c, q):
        return minimize(lambda x: bowl(x, a, b, c, q, jnp), x0,
                        method="BFGS", options={"maxiter": 100, "gtol": 1e-6})

    jr = jax.vmap(solve)(X0, A, BE, CE, QE)
    res = pbfgs.minimize_bfgs(rows_vg(), torch.as_tensor(X0), maxiter=100,
                              gtol=1e-6)
    np.testing.assert_array_equal(res.k.numpy(), np.asarray(jr.nit))
    np.testing.assert_allclose(res.x_k.numpy(), np.asarray(jr.x),
                               atol=X_JAX)


def test_batched_bfgs_frozen_rows_keep_their_state():
    """A row that has stopped is never evaluated into: its x, f, g and k
    are those of its own stop, whatever the other rows still do."""
    calls = []
    vg = rows_vg()

    def spy(X):
        calls.append(X.clone())
        return vg(X)

    res = pbfgs.minimize_bfgs(spy, torch.as_tensor(X0), maxiter=100,
                              gtol=1e-6)
    # row 0 converged at its start: every evaluation saw it there
    assert all(torch.equal(c[0], torch.as_tensor(X0[0])) for c in calls)
    assert torch.equal(res.x_k[0], torch.as_tensor(X0[0]))
    assert len(calls) >= int(res.nfev.max())


# ---------------------------------------------------------------------------
# The ROI solvers on them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_scene():
    return flow_scene(np.random.default_rng(0), *FLOW, 6000, SMALL)


def test_roi_bfgs_is_one_batched_solve(small_scene, monkeypatch):
    seen = []
    real = pc.minimize_bfgs

    def spy(vg, x0, **kw):
        seen.append(tuple(x0.shape))
        return real(vg, x0, **kw)

    monkeypatch.setattr(pc, "minimize_bfgs", spy)
    kw = dict(roi_size=(12, 16), img_size=SMALL, maxiter=10, capacity=2048,
              solver="bfgs")
    ref, got = both(small_scene, **kw)
    assert seen == [(4, 2)]
    check(ref, got)


class _JaxFullFrameVariance(J.models.variance_objective):
    """A variance objective under a name the patch loss does not know: the
    ROI solvers take the full-frame loss."""

    def __init__(self):
        super().__init__()
        self.name = "variance_full_frame"


class _PortFullFrameVariance(P.models.variance_objective):
    def __init__(self):
        super().__init__()
        self.name = "variance_full_frame"


@pytest.mark.parametrize("solver", ["gd", "bfgs"])
def test_full_frame_objective_roi_solve_matches_jax(small_scene, solver):
    assert "variance_full_frame" not in pc.PATCH_OBJECTIVES
    kw = dict(roi_size=(12, 16), img_size=SMALL, maxiter=10, capacity=2048,
              solver=solver,
              obj=(_JaxFullFrameVariance(), _PortFullFrameVariance()))
    ref, got = both(small_scene, **kw)
    check(ref, got)


def test_full_frame_roi_loss_equals_per_roi_loop(small_scene):
    """The full-frame ROI loss, one batched evaluation over a row per ROI
    and grid sample, against each ROI's own ``make_objective_loss``."""
    bx, by, bt, bp, bm, org, _ = pc.bucket_events_by_roi(
        *small_scene, SMALL, (12, 16), 2048, device=CPU)
    obj = _PortFullFrameVariance()
    solve = pc.make_roi_solve_one(P.models.linvel_warp(), obj, SMALL,
                                  (12, 16), 1.0, 3)
    params, f_evals = solve(bx, by, bt, bp, bm, org.float())
    single = pc.make_objective_loss(obj, P.models.linvel_warp(), SMALL, 1.0,
                                    iwe_impl="matmul")
    ref = torch.stack([single(params[r], bx[r], by[r], bt[r], bp[r], bm[r])
                       for r in range(params.shape[0])])
    assert_rel(f_evals, ref, LOOP_REL)


@pytest.mark.parametrize("limit", ["slots", "image_bytes"])
def test_full_frame_roi_solve_splits_into_chunks(small_scene, monkeypatch,
                                                 limit):
    """A full-frame ROI solve whose rows (ROI x grid sample) pass either
    chunk limit evaluates them in several chunks, a row's samples kept
    together, and gives the answers of the unsplit solve."""
    kw = dict(roi_size=(12, 16), img_size=SMALL, maxiter=4, capacity=2048,
              obj=_PortFullFrameVariance(), device=CPU)
    rows = []
    real = pc.get_iwe

    def spy(params, *a, **k):      # one call per chunk of the loss
        rows.append(params.shape[0] if params.dim() == 2 else 0)
        return real(params, *a, **k)

    monkeypatch.setattr(pc, "get_iwe", spy)
    whole = pc.grid_cmax_batched(*small_scene, **kw)
    image = 16 * (SMALL[0] + 1) * (SMALL[1] + 1)
    if limit == "slots":
        monkeypatch.setattr(pc, "BATCH_MAX_SLOTS", 2048 * 50)
    else:
        monkeypatch.setattr(pc, "BATCH_MAX_IMAGE_BYTES", image * 50)
    assert max(rows) == 100            # 4 ROIs x 25 samples of the grid
    del rows[:]
    assert pc.batch_chunk(2048, SMALL) == 50
    split = pc.grid_cmax_batched(*small_scene, **kw)
    assert max(rows) == 50 and rows.count(50) >= 2   # 2 ROIs a chunk
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
