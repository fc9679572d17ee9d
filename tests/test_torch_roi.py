"""Parity of the port's ROI-bucketed path against the JAX package: the
per-tile voxel kernel, ROI bucketing, tiled and variant voxel grids, the
batched patch loss and the small helpers of the ROI solvers.

The same numpy inputs from a seed go through both packages; the port runs
with ``device="cpu"`` (kernel wrappers take their plain versions), the JAX
Pallas kernels run in interpret mode. Tolerances, relative to the output's
max |value|:

- per-tile voxel kernel and tiled voxel grids against JAX 'hilo': 1e-5;
- against the exact f32 routes: 1e-5;
- bucketing, neighbour median, segmentation, tier-2 packing: exact;
- patch losses against JAX's bf16 one-hot product: 4e-3 for values and
  gradients (the bf16 class; the port accumulates in f32).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu.ops.pallas_scatter import voxel_matmul_tiles as j_tiles
from event_utils_tpu.representations import voxel_grid as jvg
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.convert import objective_from_jax
from event_utils_tpu_torch.ops import cuda_scatter as cs

torch.set_num_threads(1)

CPU = "cpu"
F32_REL = 1e-5
HILO_REL = 1e-5
BF16_REL = 4e-3


def assert_rel(got, ref, rel, floor=1.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def t(a):
    return torch.as_tensor(np.asarray(a))


def flow_scene(rng, vx, vy, n_events, sensor, n_points=25, t_max=1.0,
               noise=0.1):
    """Points moving with a planted velocity (the JAX tests' scene)."""
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
    return xs[keep], ys[keep], ts[keep], pol[idx][keep]


# ---------------------------------------------------------------------------
# The per-tile voxel kernel (Pallas row 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["window", "mask", "override", "dead"])
def test_voxel_tiles_plain_matches_jax_kernel(rng, case):
    """``voxel_tiles_scatter_plain`` through ``voxel_tiles_inputs`` against
    the Pallas ``voxel_matmul_tiles``: out-of-tile slots always, plus a
    mask, a t0/t1 override, or whole dead tails (zero-weight slots)."""
    T, cap, B, tile = 4, 600, 3, (16, 24)
    bx = rng.integers(-2, tile[1] + 2, (T, cap))
    by = rng.integers(-2, tile[0] + 2, (T, cap))
    bt = np.sort(rng.uniform(0, 1, (T, cap)), axis=1).astype(np.float32)
    bp = rng.choice([-1.0, 1.0], (T, cap)).astype(np.float32)
    t0, t1, mask = 0.0, 1.0, None
    if case == "mask":
        mask = (rng.random((T, cap)) > 0.25).astype(np.float32)
    elif case == "override":
        t0, t1 = 0.15, 0.7
    elif case == "dead":
        bp[:, cap // 2:] = 0.0
        bp[1] = 0.0
    ref = np.asarray(j_tiles(bx, by, bt, bp, B, tile, np.float32(t0),
                             np.float32(t1), mask=mask))
    got = cs.voxel_matmul_tiles(t(bx), t(by), t(bt), t(bp), B, tile, t0, t1,
                                mask=mask)
    assert got.shape == (T, B) + tile and got.dtype == torch.float32
    assert_rel(got, ref, HILO_REL)
    args = cs.voxel_tiles_inputs(t(bx), t(by), t(bt), t(bp), B, tile, t0,
                                 t1, mask=mask)
    dead = args[3] == 0
    assert bool((args[2][dead] == -100.0).all())
    assert_rel(cs.voxel_tiles_scatter(*args, B, *tile), got.numpy(),
               F32_REL)


def test_voxel_tiles_last_bin_and_empty():
    B, tile = 4, (8, 8)
    one = [torch.tensor([[3]], dtype=torch.int32),
           torch.tensor([[5]], dtype=torch.int32),
           torch.tensor([[float(B - 1)]]), torch.tensor([[2.0]])]
    out = cs.voxel_tiles_scatter(*one, B, *tile)
    assert float(out[0, B - 1, 5, 3]) == 2.0 and float(out.sum()) == 2.0
    empty = cs.voxel_matmul_tiles(torch.zeros((3, 0)), torch.zeros((3, 0)),
                                  torch.zeros((3, 0)), torch.zeros((3, 0)),
                                  B, tile, 0.0, 1.0)
    assert empty.shape == (3, B) + tile and float(empty.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fits", "overflow", "counts", "negative",
                                  "auto_capacity"])
def test_bucket_events_by_roi_exact(rng, case):
    n, res, roi = 3000, (40, 60), (20, 20)
    xs = rng.integers(0, res[1], n).astype(np.float64)
    ys = rng.integers(0, res[0], n).astype(np.float64)
    ts = np.sort(rng.uniform(0, 1, n))
    ps = rng.choice([-1.0, 1.0], n)
    kw = {"capacity": 1024}
    if case == "overflow":
        kw = {"capacity": 256, "rng": None}
    elif case == "counts":
        kw = {"capacity": 300, "return_counts": True}
    elif case == "negative":
        xs[::7] -= 70.0
        ys[::5] = -3.0
    elif case == "auto_capacity":
        kw = {}
    jkw = dict(kw)
    pkw = dict(kw)
    if "rng" in kw:
        jkw["rng"] = np.random.default_rng(5)
        pkw["rng"] = np.random.default_rng(5)
    ref = jc.bucket_events_by_roi(xs, ys, ts, ps, res, roi, **jkw)
    got = pc.bucket_events_by_roi(xs, ys, ts, ps, res, roi, device=CPU, **pkw)
    assert len(got) == len(ref)
    for a, b in zip(got[:6], ref[:6]):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[6] == ref[6]
    if case in ("overflow", "counts"):
        assert got[6] > 0
    if case == "counts":
        np.testing.assert_array_equal(got[7], ref[7])


def test_bucket_default_generator_matches(rng):
    """Overflow without an explicit generator: both draw from
    default_rng(0)."""
    xs = rng.integers(0, 30, 2000)
    ys = rng.integers(0, 20, 2000)
    ts = np.sort(rng.random(2000))
    ps = np.ones(2000)
    ref = jc.bucket_events_by_roi(xs, ys, ts, ps, (20, 30), (10, 10), 64)
    got = pc.bucket_events_by_roi(xs, ys, ts, ps, (20, 30), (10, 10), 64,
                                  device=CPU)
    for a, b in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tier2_shapes_and_pack_roi_subset(rng):
    for args in ((100, 3), (513, 9), (5000, 17), (1 << 20, 1)):
        assert pc._tier2_shapes(*args) == jc._tier2_shapes(*args)
    xs = rng.integers(0, 60, 4000)
    ys = rng.integers(0, 40, 4000)
    ts = np.sort(rng.random(4000))
    ps = rng.choice([-1.0, 1.0], 4000)
    for cap in (2048, 256):
        ref = jc._pack_roi_subset(xs, ys, ts, ps, (40, 60), (20, 20),
                                  [1, 4], cap, 8)
        got = pc._pack_roi_subset(xs, ys, ts, ps, (40, 60), (20, 20),
                                  [1, 4], cap, 8, device=CPU)
        for a, b in zip(got[:6], ref[:6]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[6] == ref[6]


# ---------------------------------------------------------------------------
# Tiled and variant voxel grids
# ---------------------------------------------------------------------------

SENSOR_VGA = (480, 640)


@pytest.fixture(scope="module")
def vga_events():
    r = np.random.default_rng(11)
    n = 20_000
    return (r.integers(0, SENSOR_VGA[1], n), r.integers(0, SENSOR_VGA[0], n),
            np.sort(r.uniform(0, 0.5, n)), r.choice([-1.0, 1.0], n))


@pytest.mark.parametrize("route", ["direct", "impl"])
def test_events_to_voxel_tiled_parity(vga_events, route):
    xs, ys, ts, ps = vga_events
    if route == "direct":
        ref = np.asarray(jvg.events_to_voxel_tiled(
            xs, ys, ts, ps, 5, SENSOR_VGA, tile=(128, 128)))
        got = P.representations.events_to_voxel_tiled(
            xs, ys, ts, ps, 5, SENSOR_VGA, tile=(128, 128), device=CPU)
    else:
        ref = np.asarray(J.representations.events_to_voxel(
            xs, ys, ts, ps, 5, SENSOR_VGA, impl="tiled"))
        got = P.representations.events_to_voxel(
            xs, ys, ts, ps, 5, SENSOR_VGA, impl="tiled", device=CPU)
    assert got.shape == (5,) + SENSOR_VGA
    assert_rel(got, ref, HILO_REL)
    exact = P.representations.events_to_voxel(xs, ys, ts, ps, 5, SENSOR_VGA,
                                              device=CPU)
    assert_rel(got, exact.numpy(), F32_REL)


def test_tiled_out_of_sensor_events_and_errors(rng):
    """Events beyond the sensor (negative, in the padded tile margin, past
    the tile grid) are dropped; the capacity guard and bad ``impl='tiled'``
    arguments raise in both packages."""
    H, W = 100, 150          # tiles (64, 64): 2 x 3 grid with margins
    n = 4000
    xs = rng.integers(-10, W + 50, n)
    ys = rng.integers(-10, H + 40, n)
    ts = np.sort(rng.random(n))
    ps = rng.choice([-1.0, 1.0], n)
    ref = np.asarray(jvg.events_to_voxel_tiled(xs, ys, ts, ps, 4, (H, W),
                                               tile=(64, 64)))
    got = P.representations.events_to_voxel_tiled(xs, ys, ts, ps, 4, (H, W),
                                                  tile=(64, 64), device=CPU)
    assert_rel(got, ref, HILO_REL)
    exact = P.representations.events_to_voxel(xs, ys, ts, ps, 4, (H, W),
                                              device=CPU)
    assert_rel(got, exact.numpy(), F32_REL)
    with pytest.raises(J.errors.ConfigurationError, match="capacity"):
        jvg.events_to_voxel_tiled(xs, ys, ts, ps, 4, (H, W), tile=(64, 64),
                                  capacity=8)
    with pytest.raises(P.errors.ConfigurationError, match="capacity"):
        P.representations.events_to_voxel_tiled(
            xs, ys, ts, ps, 4, (H, W), tile=(64, 64), capacity=8, device=CPU)
    for bad in ({"mask": np.ones(n)}, {"t0": 0.1},
                {"temporal_bilinear": False}):
        with pytest.raises(J.errors.ConfigurationError):
            J.representations.events_to_voxel(xs, ys, ts, ps, 4, (H, W),
                                              impl="tiled", **bad)
        with pytest.raises(P.errors.ConfigurationError):
            P.representations.events_to_voxel(xs, ys, ts, ps, 4, (H, W),
                                              impl="tiled", device=CPU, **bad)


@pytest.mark.parametrize("impl", [None, "matmul"])
def test_voxel_variants_parity(rng, impl):
    sensor = (24, 32)
    n = 3000
    xs = rng.integers(0, sensor[1], n)
    ys = rng.integers(0, sensor[0], n)
    ts = np.sort(rng.uniform(0, 1.0, n))
    ps = rng.choice([-1.0, 1.0], n)
    rel = HILO_REL if impl else F32_REL
    kw = dict(sensor_size=sensor, impl=impl)
    for a, b in zip(P.representations.events_to_neg_pos_voxel(
            xs, ys, ts, ps, 3, device=CPU, **kw),
            J.representations.events_to_neg_pos_voxel(xs, ys, ts, ps, 3,
                                                      **kw)):
        assert_rel(a, np.asarray(b), rel)
    assert_rel(P.representations.events_to_voxel_timesync(
        xs, ys, ts, ps, 3, 0.2, 0.6, device=CPU, **kw),
        np.asarray(J.representations.events_to_voxel_timesync(
            xs, ys, ts, ps, 3, 0.2, 0.6, **kw)), rel)
    got_n = P.representations.voxel_grids_fixed_n(xs, ys, ts, ps, 3, 700,
                                                  device=CPU, **kw)
    ref_n = np.asarray(J.representations.voxel_grids_fixed_n(
        xs, ys, ts, ps, 3, 700, **kw))
    assert got_n.shape == (4, 3) + sensor
    assert_rel(got_n, ref_n, rel)
    got_t = P.representations.voxel_grids_fixed_t(xs, ys, ts, ps, 3, 0.3,
                                                  device=CPU, **kw)
    ref_t = J.representations.voxel_grids_fixed_t(xs, ys, ts, ps, 3, 0.3,
                                                  **kw)
    assert len(got_t) == len(ref_t) == 3
    for a, b in zip(got_t, ref_t):
        assert_rel(a, np.asarray(b), rel)
    assert_rel(P.representations.events_to_voxel_torch(
        xs, ys, ts, ps, 3, CPU, **kw),
        np.asarray(J.representations.events_to_voxel_torch(
            xs, ys, ts, ps, 3, None, **kw)), rel)
    assert P.representations.voxel_grids_fixed_n(
        xs[:5], ys[:5], ts[:5], ps[:5], 3, 700, device=CPU,
        **kw).shape == (0, 3) + sensor
    vg = got_n[0]
    np.testing.assert_allclose(P.representations.get_voxel_grid_as_image(vg),
                               J.representations.get_voxel_grid_as_image(
                                   ref_n[0]), rtol=1e-4, atol=1e-3)
    with pytest.raises(P.errors.ConfigurationError):
        P.representations.events_to_voxel_timesync(xs, ys, ts, ps, 3, 0.6,
                                                   0.2, device=CPU)


# ---------------------------------------------------------------------------
# The batched patch loss
# ---------------------------------------------------------------------------

OBJECTIVES = [("variance", {}), ("rms", {}), ("sos", {}), ("soe", {}),
              ("moa", {}), ("isoa", {"thresh": 0.4}), ("sosa", {"p": 2}),
              ("zhu", {}), ("r1", {"p": 2})]


@pytest.fixture(scope="module")
def roi_batch():
    r = np.random.default_rng(3)
    xs, ys, ts, ps = flow_scene(r, 15.0, -8.0, 2500, (40, 60))
    jb = jc.bucket_events_by_roi(xs, ys, ts, ps, (40, 60), (20, 20), 512)
    pb = pc.bucket_events_by_roi(xs, ys, ts, ps, (40, 60), (20, 20), 512,
                                 device=CPU)
    R = pb[0].shape[0]
    params = (np.array([[14.0, -7.0]], np.float32)
              + r.normal(0, 2, (R, 3, 2)).astype(np.float32))
    return jb, pb, params


@pytest.mark.parametrize("name,kw", OBJECTIVES)
def test_make_patch_loss_value_and_grad(roi_batch, name, kw):
    """Every objective, every ROI and 3 parameter samples in one batched
    evaluation, against JAX's vmapped per-ROI loss."""
    jb, pb, params = roi_batch
    jobj = J.models.get_objective(name, **kw)
    full = 41 * 61
    jl = jc.make_patch_loss(J.models.linvel_warp(), (20, 20), jobj,
                            full_pixels=full)
    pl = pc.make_patch_loss(P.models.linvel_warp(), (20, 20),
                            objective_from_jax(jobj), full_pixels=full)
    per_sample = jax.vmap(jax.value_and_grad(jl),
                          in_axes=(0, None, None, None, None, None, None))
    jv, jg = jax.jit(jax.vmap(per_sample))(
        jnp.asarray(params), *jb[:5], jnp.asarray(jb[5], jnp.float32))
    pt = torch.tensor(params, requires_grad=True)
    pv = pl(pt, *pb[:5], pb[5].float())
    (pg,) = torch.autograd.grad(pv.sum(), pt)
    assert pv.shape == params.shape[:2]
    assert_rel(pv, np.asarray(jv), BF16_REL, floor=1e-6)
    assert_rel(pg, np.asarray(jg), BF16_REL, floor=1e-6)
    # the (R, dims) and single-ROI forms give the same numbers, to the f32
    # rounding of the coordinates' atlas offsets (which depend on the count
    # of patches)
    with torch.no_grad():
        assert_rel(pl(t(params[:, 0]), *pb[:5], pb[5].float()),
                   pv[:, 0].detach().numpy(), F32_REL, floor=1e-6)
        one = pl(t(params[2]), *(a[2] for a in pb[:5]), pb[5][2].float())
        assert_rel(one, pv[2].detach().numpy(), F32_REL, floor=1e-6)


def test_patch_loss_empty_roi_is_finite(roi_batch):
    _, pb, params = roi_batch
    pl = pc.make_patch_loss(P.models.linvel_warp(), (20, 20), "variance")
    mask = pb[4].clone()
    mask[1] = 0.0
    out = pl(t(params[:, 0]), *pb[:4], mask, pb[5].float())
    assert bool(torch.isfinite(out).all()) and float(out[1]) == 0.0
    alias = pc.make_patch_variance_loss(P.models.linvel_warp(), (20, 20))
    assert_rel(alias(t(params[:, 0]), *pb[:5], pb[5].float()),
               pl(t(params[:, 0]), *pb[:5], pb[5].float()).numpy(), 1e-7)


def test_grid_search_refine_batched_matches_vmap(roi_batch):
    """Per-ROI init ranges, every ROI's 25 samples in one evaluation."""
    jb, pb, _ = roi_batch
    jl = jc.make_patch_loss(J.models.linvel_warp(), (20, 20), "variance",
                            full_pixels=41 * 61)
    pl = pc.make_patch_loss(P.models.linvel_warp(), (20, 20), "variance",
                            full_pixels=41 * 61)
    ranges = np.array([150.0, 40.0, 80.0, 30.0, 150.0, 60.0],
                      np.float32)[:pb[0].shape[0]]
    org = jnp.asarray(jb[5], jnp.float32)

    def one(ex, ey, et, ep, em, o, r):
        return jc.grid_search_refine(
            lambda p: jl(p, ex, ey, et, ep, em, o), 2, init_range=r, iters=6)

    jp, je = jax.jit(jax.vmap(one))(*jb[:5], org, jnp.asarray(ranges))
    pp, pe = pc.grid_search_refine_batched(
        lambda c: pl(c, *pb[:5], pb[5].float()), 2, t(ranges), iters=6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=0.5)
    assert_rel(pe, np.asarray(je), BF16_REL, floor=1e-6)


# ---------------------------------------------------------------------------
# Helpers of the solvers
# ---------------------------------------------------------------------------

def test_neighbor_median_exact(rng):
    """Even and odd valid counts (numpy's midpoint rule), NaN-ignoring, and
    ROIs without a valid neighbour keep their own params."""
    ny, nx, d = 4, 5, 2
    params = rng.normal(0, 10, (ny * nx, d)).astype(np.float32)
    valid = rng.random(ny * nx) > 0.35
    valid[:2] = False
    ref = np.asarray(jc._neighbor_median(jnp.asarray(params),
                                         jnp.asarray(valid), ny, nx))
    got = pc._neighbor_median(t(params), t(valid), ny, nx)
    np.testing.assert_array_equal(got.numpy(), ref)
    lone = np.zeros(ny * nx, bool)
    got = pc._neighbor_median(t(params), t(lone), ny, nx)
    np.testing.assert_array_equal(got.numpy(), params)


def test_segmentation_velocity_field_and_colormap(rng):
    d_iwe = rng.normal(0, 1, (2, 41, 61)).astype(np.float32)
    for th in (None, 0.5):
        np.testing.assert_array_equal(
            pc.segmentation_mask_from_d_iwe(t(d_iwe), th=th),
            jc.segmentation_mask_from_d_iwe(d_iwe, th=th))
    params = np.array([3.0, -2.0, 0.01, -0.02], np.float32)
    x = rng.uniform(0, 60, 10)
    y = rng.uniform(0, 40, 10)
    np.testing.assert_array_equal(
        pc.xyztheta_velocity_at(t(params), x, y),
        jc.xyztheta_velocity_at(params, x, y))
    cmap = pc.get_hsv_shifted()
    assert cmap.N == 100 and np.allclose(cmap(0.5), cmap(0.5))
