"""Parity of the PyTorch port's representations against the JAX package.

Numpy inputs from a seed go through both packages (the port with
``device="cpu"``; the JAX 'matmul' routes run the Pallas kernels in
interpret mode). Tolerances relative to the output's max |value|: 1e-5 for
f32 paths, 3e-5 against the JAX 'hilo' kernels, 4e-3 against 'bf16'.
"""

import numpy as np
import pytest
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu_torch.ops import cuda_scatter as cs
from event_utils_tpu_torch.representations import image as pimage

torch.set_num_threads(1)

CPU = "cpu"
SENSOR = (24, 32)
F32_REL = 1e-5
HILO_REL = 3e-5
BF16_REL = 4e-3


def assert_rel(got, ref, rel, floor=1.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def events(rng, n=3000, sensor=SENSOR, oob=2, floats=False):
    H, W = sensor
    if floats:
        xs = rng.uniform(-oob, W + oob, n)
        ys = rng.uniform(-oob, H + oob, n)
    else:
        xs = rng.integers(-oob, W + oob, n)
        ys = rng.integers(-oob, H + oob, n)
    ts = np.sort(rng.uniform(0, 0.5, n))
    ps = rng.choice([-1.0, 1.0], n)
    return xs, ys, ts, ps


def tol(impl):
    if impl == "matmul_bf16":
        return BF16_REL
    return HILO_REL if impl and impl.startswith("matmul") else F32_REL


# ---------------------------------------------------------------------------
# Voxel grids
# ---------------------------------------------------------------------------

VOXEL_IMPLS = [None, "sort", "pallas", "matmul", "matmul_bf16", "matmul_int8"]


@pytest.mark.parametrize("impl", VOXEL_IMPLS)
@pytest.mark.parametrize("route", ["bilinear_t", "slices", "spatial"])
def test_events_to_voxel_parity(rng, impl, route):
    floats = route == "spatial"
    xs, ys, ts, ps = events(rng, floats=floats)
    kw = dict(temporal_bilinear=route != "slices",
              spatial_interpolation="bilinear" if floats else None)
    jimpl = None if impl == "pallas" else impl  # JAX 'pallas' flat: slow
    ref = np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, 5, SENSOR, impl=jimpl, **kw))
    got = P.representations.events_to_voxel(xs, ys, ts, ps, 5, SENSOR,
                                            impl=impl, device=CPU, **kw)
    assert got.shape == (5,) + SENSOR and got.dtype == torch.float32
    assert_rel(got, ref, tol(jimpl))


@pytest.mark.parametrize("impl", [None, "matmul"])
@pytest.mark.parametrize("case", ["mask", "t0", "t1", "t0t1_outside"])
def test_events_to_voxel_mask_and_window_overrides(rng, impl, case):
    xs, ys, ts, ps = events(rng)
    kw = {}
    if case == "mask":
        m = (rng.random(len(xs)) > 0.3).astype(np.float32)
        m[:7] = 0
        m[-3:] = 0          # window from the first/last *valid* event
        kw["mask"] = m
    elif case == "t0":
        kw["t0"] = float(ts[100])
    elif case == "t1":
        kw["t1"] = float(ts[len(ts) // 2])
    else:
        kw.update(t0=float(ts[0]) - 0.1, t1=float(ts[-1]) - 0.2)
    ref = np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, 4, SENSOR, impl=impl, **kw))
    got = P.representations.events_to_voxel(xs, ys, ts, ps, 4, SENSOR,
                                            impl=impl, device=CPU, **kw)
    assert_rel(got, ref, 2e-4 if impl else F32_REL)
    exact = np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, 4, SENSOR, **kw))
    assert_rel(got, exact, F32_REL)


@pytest.mark.parametrize("impl", [None, "matmul"])
def test_events_to_voxel_zero_events_single_event_and_oob(impl):
    z = np.zeros(0)
    if impl is None:
        # the exact route reads the window from ts[0], ts[-1]: both
        # packages raise IndexError on an empty stream
        with pytest.raises(IndexError):
            J.representations.events_to_voxel(z, z, z, z, 3, SENSOR)
        with pytest.raises(IndexError):
            P.representations.events_to_voxel(z, z, z, z, 3, SENSOR,
                                              device=CPU)
    else:
        out = P.representations.events_to_voxel(z, z, z, z, 3, SENSOR,
                                                impl=impl, device=CPU)
        ref = np.asarray(J.representations.events_to_voxel(
            z, z, z, z, 3, SENSOR, impl=impl))
        assert_rel(out, ref, F32_REL)
        assert float(out.abs().sum()) == 0
    # dt == 0: one event, and all events at one timestamp
    one = P.representations.events_to_voxel(np.array([3]), np.array([4]),
                                            np.array([1.5]), np.array([1.0]),
                                            3, SENSOR, impl=impl, device=CPU)
    ref = np.asarray(J.representations.events_to_voxel(
        np.array([3]), np.array([4]), np.array([1.5]), np.array([1.0]), 3,
        SENSOR))
    assert_rel(one, ref, F32_REL)
    assert float(one[0, 4, 3]) == 1.0
    same_t = P.representations.events_to_voxel(
        np.array([1, 2]), np.array([1, 2]), np.array([0.2, 0.2]),
        np.array([1.0, -1.0]), 3, SENSOR, impl=impl, device=CPU)
    assert float(same_t.sum()) == 0.0 and float(same_t[0, 1, 1]) == 1.0
    # every event outside the image (negative and beyond): dropped
    bad = P.representations.events_to_voxel(
        np.array([-1, 32, 5, 5]), np.array([3, 3, -1, 24]),
        np.array([0.0, 0.1, 0.2, 0.3]), np.ones(4), 3, SENSOR, impl=impl,
        device=CPU)
    assert float(bad.abs().sum()) == 0.0


def test_events_to_voxel_truncates_negative_float_coords():
    # -0.5 truncates to 0 (in the image); -1.5 to -1 (dropped)
    xs = np.array([-0.5, -1.5, 2.7])
    ys = np.array([1.2, 1.2, 1.9])
    for impl in (None, "matmul"):
        got = P.representations.events_to_voxel(
            xs, ys, np.array([0.0, 0.5, 1.0]), np.ones(3), 2, SENSOR,
            impl=impl, device=CPU)
        ref = np.asarray(J.representations.events_to_voxel(
            xs, ys, np.array([0.0, 0.5, 1.0]), np.ones(3), 2, SENSOR,
            impl=impl))
        assert_rel(got, ref, HILO_REL)
        assert float(got[:, 1, 0].sum()) == 1.0


def test_voxel_tensors_keep_their_device(rng):
    xs, ys, ts, ps = events(rng, 200)
    out = P.representations.events_to_voxel(
        torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(ts),
        torch.as_tensor(ps), 3, SENSOR)
    assert out.device.type == "cpu" and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# Event images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "sort", "matmul"])
@pytest.mark.parametrize("interp,padding,meanval", [
    (None, False, False), (None, False, True), ("bilinear", False, False),
    ("bilinear", True, True)])
def test_events_to_image_parity(rng, impl, interp, padding, meanval):
    xs, ys, ts, ps = events(rng, floats=interp == "bilinear")
    mask = (rng.random(len(xs)) > 0.2).astype(np.float32)
    kw = dict(interpolation=interp, padding=padding, meanval=meanval,
              default=0.5 if meanval else 0, mask=mask)
    ref = np.asarray(J.representations.events_to_image(
        xs, ys, ps, SENSOR, impl=impl, **kw))
    got = P.representations.events_to_image(xs, ys, ps, SENSOR, impl=impl,
                                            device=CPU, **kw)
    assert_rel(got, ref, tol(impl))


@pytest.mark.parametrize("interp", [None, "bilinear"])
@pytest.mark.parametrize("legacy", [False, True])
def test_events_to_image_torch_legacy_mask(rng, interp, legacy):
    xs, ys, ts, ps = events(rng, floats=interp == "bilinear", oob=4)
    ref = np.asarray(J.representations.events_to_image_torch(
        xs, ys, ps, sensor_size=SENSOR, interpolation=interp,
        legacy_mask=legacy))
    got = P.representations.events_to_image_torch(
        xs, ys, ps, device=CPU, sensor_size=SENSOR, interpolation=interp,
        legacy_mask=legacy)
    assert_rel(got, ref, F32_REL)


@pytest.mark.parametrize("impl", [None, "matmul"])
@pytest.mark.parametrize("legacy", [False, True])
def test_events_to_image_drv_parity(rng, impl, legacy):
    xs, ys, ts, ps = events(rng, floats=True, oob=3)
    jx = rng.normal(size=(2, len(xs))).astype(np.float32)
    jy = rng.normal(size=(2, len(xs))).astype(np.float32)
    mask = rng.random(len(xs)) > 0.1
    riwe, rd = J.representations.events_to_image_drv(
        xs, ys, ps, jx, jy, SENSOR, compute_gradient=True, mask=mask,
        legacy_mask=legacy, impl=impl)
    giwe, gd = P.representations.events_to_image_drv(
        xs, ys, ps, jx, jy, SENSOR, compute_gradient=True, mask=mask,
        legacy_mask=legacy, impl=impl, device=CPU)
    assert giwe.shape == (SENSOR[0] + 1, SENSOR[1] + 1)
    assert_rel(giwe, np.asarray(riwe), tol(impl))
    assert_rel(gd, np.asarray(rd), tol(impl))
    no_grad = P.representations.events_to_image_drv(
        xs, ys, ps, None, None, SENSOR, device=CPU)[1]
    assert no_grad is None


def test_image_to_event_weights_parity(rng):
    xs, ys, ts, ps = events(rng, floats=True, oob=3)
    img = rng.normal(size=SENSOR).astype(np.float32)
    mask = rng.random(len(xs)) > 0.3
    ref = np.asarray(J.representations.image_to_event_weights(xs, ys, img,
                                                              mask=mask))
    got = P.representations.image_to_event_weights(xs, ys, img, mask=mask,
                                                   device=CPU)
    assert_rel(got, ref, F32_REL)


# ---------------------------------------------------------------------------
# Timestamp images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "matmul", "matmul_bf16"])
@pytest.mark.parametrize("kw", [
    {}, {"legacy_mask": True}, {"timestamp_reverse": True},
    {"normalize_timestamps": False, "padding": False},
    {"interpolation": None, "padding": False}, {"mask": "random"}])
def test_events_to_timestamp_image_parity(rng, impl, kw):
    xs, ys, ts, ps = events(rng, floats=True, oob=3)
    kw = dict(kw)
    if kw.get("mask") == "random":
        kw["mask"] = (rng.random(len(xs)) > 0.3).astype(np.float32)
    rpos, rneg = J.representations.events_to_timestamp_image(
        xs, ys, ts, ps, SENSOR, impl=impl, **kw)
    gpos, gneg = P.representations.events_to_timestamp_image(
        xs, ys, ts, ps, SENSOR, impl=impl, device=CPU, **kw)
    assert_rel(gpos, np.asarray(rpos), tol(impl))
    assert_rel(gneg, np.asarray(rneg), tol(impl))


def test_timestamp_stack_is_one_bilinear_launch(rng, monkeypatch):
    """The K=4 stack (ts*pos, pos, ts*neg, neg) goes through the bilinear
    kernel wrapper once, with all four channels (one image: the batched
    wrapper at S = 1)."""
    calls = []
    real = cs.bilinear_scatter_batched

    def spy(x, y, w, H, W, route=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, y, w, H, W, route=route)

    monkeypatch.setattr(cs, "bilinear_scatter_batched", spy)
    xs, ys, ts, ps = events(rng, 500, floats=True)
    P.representations.events_to_timestamp_image(xs, ys, ts, ps, SENSOR,
                                                impl="matmul", device=CPU)
    assert calls == [((1, 500), (4, 500))]


def test_timestamp_weight_sums_parity(rng):
    from event_utils_tpu.representations.image import (
        _timestamp_weight_sums as jsums)
    xs, ys, ts, ps = events(rng, floats=True)
    nts = ((ts - ts[0]) / (ts[-1] - ts[0])).astype(np.float32)
    img_size = (SENSOR[0] + 1, SENSOR[1] + 1)
    args = (img_size, img_size[1] - 1, img_size[0] - 1, True, False)
    ref = np.asarray(jsums(xs.astype(np.float32), ys.astype(np.float32), nts,
                           ps.astype(np.float32), None, *args, None))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    got = pimage._timestamp_weight_sums(t(xs), t(ys), t(nts), t(ps), None,
                                        *args, "matmul")
    assert got.shape == (4,) + img_size
    assert_rel(got, ref, F32_REL)


# ---------------------------------------------------------------------------
# Reference-signature shims and the stateful accumulators
# ---------------------------------------------------------------------------

def test_interpolate_shims_parity(rng):
    xs, ys, ts, ps = events(rng, floats=True, oob=2)
    dx = rng.uniform(-0.5, 0.5, len(xs))
    dy = rng.uniform(-0.5, 0.5, len(xs))
    img = rng.normal(size=SENSOR).astype(np.float32)
    ref = np.asarray(J.representations.interpolate_to_image(xs, ys, dx, dy,
                                                            ps, img))
    got = P.representations.interpolate_to_image(xs, ys, dx, dy, ps,
                                                 torch.as_tensor(img))
    assert_rel(got, ref, F32_REL)
    d_img = rng.normal(size=(2,) + SENSOR).astype(np.float32)
    w1 = rng.normal(size=len(xs))
    w2 = rng.normal(size=len(xs))
    ref = np.asarray(J.representations.interpolate_to_derivative_img(
        xs, ys, dx, dy, d_img, w1, w2))
    got = P.representations.interpolate_to_derivative_img(
        xs, ys, dx, dy, torch.as_tensor(d_img), w1, w2)
    assert_rel(got, ref, F32_REL)


def test_timestamp_image_torch_alias_and_accumulators(rng):
    xs, ys, ts, ps = events(rng, floats=True, oob=0)
    ref = J.representations.events_to_timestamp_image_torch(
        xs, ys, ts, ps, sensor_size=SENSOR)
    got = P.representations.events_to_timestamp_image_torch(
        xs, ys, ts, ps, device=CPU, sensor_size=SENSOR)
    for a, b in zip(got, ref):
        assert_rel(a, np.asarray(b), F32_REL)
    ix = rng.integers(0, SENSOR[1], 500)
    iy = rng.integers(0, SENSOR[0], 500)
    its = np.sort(rng.random(500))
    ips = rng.choice([-1.0, 1.0], 500)
    for name in ("TimestampImage", "EventImage"):
        j = getattr(J.representations, name)(SENSOR)
        p = getattr(P.representations, name)(SENSOR)
        for acc in (j, p):
            acc.add_events(ix[:-1], iy[:-1], its[:-1], ips[:-1])
            acc.add_event(ix[-1], iy[-1], its[-1], ips[-1])
        np.testing.assert_array_equal(p.get_image(), j.get_image())
