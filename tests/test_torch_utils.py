"""Parity of the port's utilities, metrics and dense-flow warp against the
JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages. The metrics
and crop geometry are the same numpy code: equal to 1e-6. The warp is f32:
1e-5 of the coordinates' scale, against the JAX package and against the
reference's own formulation (``F.grid_sample`` with ``align_corners=True``
and zero padding).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import event_utils_tpu.utils.metrics as jmetrics
import event_utils_tpu.utils.util as jutil
from event_utils_tpu.transforms.optic_flow import (
    warp_events_flow as jwarp)
import event_utils_tpu_torch.utils.metrics as pmetrics
import event_utils_tpu_torch.utils.util as putil
from event_utils_tpu_torch.transforms import (warp_events_flow,
                                              warp_events_flow_torch)

SENSOR = (24, 32)


@pytest.fixture
def gen():
    return np.random.default_rng(11)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 28), (3, 20, 28), (2, 2, 16, 16)])
@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_image_metrics_match_jax(gen, shape, name):
    pred = gen.uniform(0, 1, shape).astype(np.float32)
    gt = np.clip(pred + gen.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ref = getattr(jmetrics, name)(pred, gt)
    got = getattr(pmetrics, name)(torch.as_tensor(pred), gt)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.shape(got) == np.shape(ref)


@pytest.mark.parametrize("shape", [(2, 12, 16), (4, 2, 12, 16)])
def test_average_endpoint_error_matches_jax(gen, shape):
    pred = gen.normal(0, 5, shape).astype(np.float32)
    gt = gen.normal(0, 5, shape).astype(np.float32)
    np.testing.assert_allclose(pmetrics.average_endpoint_error(pred, gt),
                               jmetrics.average_endpoint_error(pred, gt),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Crop geometry, flow coloring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,height,enc,margin",
                         [(240, 180, 3, 0), (346, 260, 4, 1), (32, 32, 3, 0),
                          (17, 9, 2, 2)])
def test_crop_parameters_match_jax(gen, width, height, enc, margin):
    ref = jutil.CropParameters(width, height, enc, margin)
    got = putil.CropParameters(width, height, enc, margin)
    assert vars(got) == vars(ref)
    img = gen.normal(size=(2, height, width)).astype(np.float32)
    padded = ref.pad(img)
    np.testing.assert_array_equal(got.pad(img), padded)
    tpad = got.pad(torch.as_tensor(img))
    assert isinstance(tpad, torch.Tensor)
    np.testing.assert_array_equal(tpad.numpy(), padded)
    np.testing.assert_array_equal(got.crop(padded), ref.crop(padded))
    assert putil.optimal_crop_size(width, enc, margin) == \
        jutil.optimal_crop_size(width, enc, margin)


@pytest.mark.parametrize("max_magnitude", [None, 7.5])
def test_flow2bgr_matches_jax(gen, max_magnitude):
    u, v = gen.normal(0, 5, (2, 12, 20))
    np.testing.assert_array_equal(
        putil.flow2bgr_np(u, v, max_magnitude),
        jutil.flow2bgr_np(u, v, max_magnitude))


# ---------------------------------------------------------------------------
# Dense-flow warp
# ---------------------------------------------------------------------------

def _events(gen, n=400, oob=3.0):
    H, W = SENSOR
    xs = gen.uniform(-oob, W + oob, n)
    ys = gen.uniform(-oob, H + oob, n)
    ts = np.sort(gen.uniform(0.0, 0.5, n))
    ps = gen.choice([-1.0, 1.0], n)
    return xs, ys, ts, ps


def _close(got, ref, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= rel * scale


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t0", [None, 0.1])
def test_warp_events_flow_matches_jax(gen, masked, t0):
    xs, ys, ts, ps = _events(gen)
    flow = gen.normal(0, 20, (2,) + SENSOR).astype(np.float32)
    mask = (gen.random(len(xs)) > 0.3).astype(np.float32) if masked else None
    ref = jwarp(xs, ys, ts, ps, flow, t0=t0, mask=mask)
    got = warp_events_flow(xs, ys, ts, ps, flow, t0=t0, mask=mask,
                           device="cpu")
    for g, r in zip(got, ref):
        _close(g, r)


def test_warp_events_flow_matches_grid_sample(gen):
    """The reference's formulation: grid_sample(align_corners=True,
    padding_mode='zeros') of the field at the events' normalized coords."""
    H, W = SENSOR
    xs, ys, ts, ps = _events(gen)
    flow = torch.as_tensor(gen.normal(0, 20, (2, H, W)), dtype=torch.float32)
    x = torch.as_tensor(xs, dtype=torch.float32)
    y = torch.as_tensor(ys, dtype=torch.float32)
    t = torch.as_tensor(ts, dtype=torch.float32)
    grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1], -1)
    uv = F.grid_sample(flow[None], grid[None, None], mode="bilinear",
                       padding_mode="zeros", align_corners=True)[0, :, 0]
    dt = t - t[-1]
    xw, yw = warp_events_flow(x, y, t, None, flow)
    _close(xw, x + uv[0] * dt)
    _close(yw, y + uv[1] * dt)


def test_warp_events_flow_sign_convention(gen):
    """Events of a feature moving at +v align when the field passed is -v
    (the function advects backward, as in the JAX package); +v doubles
    their spread."""
    v = np.array([30.0, -20.0])
    n = 300
    ts = np.sort(gen.uniform(0, 0.2, n))
    xs = 10.0 + v[0] * ts
    ys = 15.0 + v[1] * ts
    field = np.broadcast_to(v[:, None, None], (2,) + SENSOR).astype(
        np.float32)
    for sign, spread in ((-1.0, 0.0), (1.0, 2 * np.ptp(xs))):
        xw, yw = warp_events_flow(xs, ys, ts, None, sign * field,
                                  device="cpu")
        assert abs(float(np.ptp(xw.numpy())) - spread) < 1e-3 * (1 + spread)
        jx, _ = jwarp(xs, ys, ts, None, sign * field)
        _close(xw, jx)


def test_warp_events_flow_single_event_and_oob():
    flow = np.zeros((2, 16, 16), np.float32)
    flow[0] = 5.0
    xw, yw = warp_events_flow(np.array([3.0]), np.array([4.0]),
                              np.array([0.5]), np.array([1.0]), flow,
                              device="cpu")
    assert tuple(xw.shape) == (1,) and tuple(yw.shape) == (1,)
    xw2, _ = warp_events_flow(np.array([-10.0, 3.0]), np.array([4.0, 4.0]),
                              np.array([0.0, 1.0]), np.array([1.0, 1.0]),
                              flow, t0=1.0, device="cpu")
    assert float(xw2[0]) == -10.0
    assert abs(float(xw2[1]) - 3.0) < 1e-5
    with pytest.raises(NotImplementedError):
        warp_events_flow_torch(np.zeros(3), np.zeros(3), np.zeros(3),
                               np.zeros(3), flow, batched=True)
