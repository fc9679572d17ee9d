"""The port's background-activity filter against the JAX package's, on the
CPU.

The filter is maxima, compares and integer indices over float32 (and
float64 epoch) stamps, so the keep mask must be JAX's bit for bit: every
case of ``tests/test_denoise.py`` and random streams with padding,
out-of-frame and fractional coordinates, both stamp widths and the
options.
"""

import numpy as np
import pytest
import torch

from event_utils_tpu.ops.denoise import background_activity_filter as jbaf
from event_utils_tpu.ops.denoise import filter_background_activity as jfilt
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DeviceUnavailableError)
from event_utils_tpu_torch.ops import denoise as D

CASES = {
    "exact_semantics": (
        [10.0, 11.0, 30.0, 10.0], [10.0, 10.0, 30.0, 10.0],
        [0.10, 0.11, 0.50, 0.90], 0.05,
        dict(sensor_size=(48, 48), n_slices=64), [True, True, False, False]),
    "center_exclusion": (
        np.full(10, 5.0), np.full(10, 5.0), np.linspace(0.0, 0.009, 10), 0.05,
        dict(sensor_size=(16, 16), n_slices=16), [False] * 10),
    "include_center": (
        np.full(10, 5.0), np.full(10, 5.0), np.linspace(0.0, 0.009, 10), 0.05,
        dict(sensor_size=(16, 16), n_slices=16, include_center=True),
        [False] + [True] * 9),
    "include_center_lone_event": (
        [5.0], [5.0], [0.1], 0.05,
        dict(sensor_size=(16, 16), n_slices=16, include_center=True),
        [False]),
    "float64_epoch": (
        [10.0, 11.0, 30.0], [10.0, 10.0, 30.0],
        1.7e9 + np.array([0.10, 0.11, 0.50]), 0.05,
        dict(sensor_size=(48, 48), n_slices=64), [False, True, False]),
    "fractional_border": (
        [46.4, 47.3, 5.0], [20.0, 20.0, 5.0], [0.100, 0.101, 5.0], 0.05,
        dict(sensor_size=(48, 48), n_slices=8), [True, True, False]),
    "mask_and_oob": (
        [10.0, 11.0, 10.0, -3.0], [10.0, 10.0, 10.0, 99.0],
        [0.10, 0.11, 0.12, 0.13], 0.05,
        dict(sensor_size=(16, 16), n_slices=8,
             mask=np.array([1.0, 0.0, 1.0, 1.0])), [False] * 4),
    "mask_all_real": (
        [10.0, 11.0, 10.0, -3.0], [10.0, 10.0, 10.0, 99.0],
        [0.10, 0.11, 0.12, 0.13], 0.05,
        dict(sensor_size=(16, 16), n_slices=8, mask=np.ones(4)),
        [False, True, True, False]),
    "float32_stamps": (
        np.float32([3.0, 4.0, 9.0]), np.float32([3.0, 3.0, 9.0]),
        np.float32([0.0, 0.001, 0.5]), 0.01,
        dict(sensor_size=(16, 16), n_slices=8, mask=np.ones(3)),
        [True, True, False]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_mask_equals_jax_on_the_reference_cases(name):
    xs, ys, ts, dt, kw, want = CASES[name]
    j = np.asarray(jbaf(np.asarray(xs), np.asarray(ys), np.asarray(ts), dt,
                        **kw))
    p = D.background_activity_filter(np.asarray(xs), np.asarray(ys),
                                     np.asarray(ts), dt, device="cpu", **kw)
    assert p.dtype == torch.bool
    np.testing.assert_array_equal(p.numpy(), j)
    assert p.numpy().tolist() == want


@pytest.mark.parametrize("seed, epoch, kw", [
    (0, 0.0, dict()),
    (1, 1.6e9, dict()),
    (2, 0.0, dict(include_center=True, support=2, n_slices=17)),
    (3, 1.6e9, dict(include_center=True, n_slices=1)),
    (4, 0.0, dict(support=3, n_slices=128)),
])
def test_keep_mask_equals_jax_on_random_streams(seed, epoch, kw):
    rng = np.random.default_rng(seed)
    n, H, W = 20000, 60, 80
    xs = rng.uniform(-2, W + 1, n)
    ys = rng.uniform(-2, H + 1, n)
    ts = epoch + np.sort(rng.uniform(0.0, 0.5, n))
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    j = np.asarray(jbaf(xs, ys, ts, 0.01, sensor_size=(H, W), mask=mask,
                        **kw))
    p = D.background_activity_filter(xs, ys, ts, 0.01, sensor_size=(H, W),
                                      mask=mask, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(p, j)
    assert 0 < p.sum() < n
    # tensors keep their device and give the same mask (f64 stamps too)
    t = D.background_activity_filter(
        torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(ts), 0.01,
        sensor_size=(H, W), mask=torch.as_tensor(mask), **kw)
    np.testing.assert_array_equal(t.numpy(), j)


def test_integer_coordinates_and_float32_stamps():
    rng = np.random.default_rng(5)
    n, H, W = 5000, 30, 40
    xs = rng.integers(-1, W + 1, n)
    ys = rng.integers(-1, H + 1, n)
    ts = np.sort(rng.uniform(0.0, 0.2, n)).astype(np.float32)
    j = np.asarray(jbaf(xs, ys, ts, 0.005, sensor_size=(H, W)))
    p = D.background_activity_filter(xs, ys, ts, 0.005, sensor_size=(H, W),
                                     device="cpu").numpy()
    np.testing.assert_array_equal(p, j)


def test_filter_background_activity_matches_jax():
    rng = np.random.default_rng(6)
    n = 3000
    xs = rng.integers(0, 32, n).astype(np.float32)
    ys = rng.integers(0, 24, n).astype(np.float32)
    ts = np.sort(rng.uniform(0.0, 0.3, n))
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    j = jfilt(xs, ys, ts, ps, 0.01, sensor_size=(24, 32), n_slices=32)
    p = D.filter_background_activity(xs, ys, ts, ps, 0.01,
                                     sensor_size=(24, 32), n_slices=32,
                                     device="cpu")
    for a, b in zip(p, j):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, np.asarray(b))
    assert 0 < len(p[0]) < n


def test_validation_and_default_device():
    with pytest.raises(ConfigurationError):
        D.background_activity_filter([0.0], [0.0], [0.0], 0.1, n_slices=0,
                                     device="cpu")
    with pytest.raises(ConfigurationError):
        D.background_activity_filter([0.0], [0.0], [0.0], 0.1, support=0,
                                     device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            D.background_activity_filter([0.0], [0.0], [0.0], 0.1)


def test_scores_against_the_port_simulator_labels():
    """The denoising loop of ``tests/test_denoise.py`` on the port: a
    sparse 48x48 scene with labelled leak and shot noise at 1 Hz, 0.1 s at
    500 fps; JAX's limits (signal recall > 0.95, noise removal > 0.6)."""
    from event_utils_tpu_torch.simulation import (SimulatorConfig,
                                                  simulate_scene,
                                                  translating_scene)

    rng = np.random.default_rng(0)
    tex = np.full((48, 48), 0.3, np.float32)
    for _ in range(6):
        y, x = rng.integers(6, 42, 2)
        tex[y - 2:y + 2, x - 2:x + 2] = 1.0
    sc = translating_scene(tex, (120.0, 50.0), device="cpu")
    cfg = SimulatorConfig(c_pos=0.2, c_neg=0.2, leak_rate_hz=1.0,
                          shot_rate_hz=1.0)
    ev, *_ = simulate_scene(sc, 0.1, 500.0, cfg,
                            generator=torch.Generator().manual_seed(1))
    assert ev.labels is not None and len(ev.labels) == len(ev)
    assert int((ev.labels == 1).sum()) == ev.stats["num_noise"] > 0
    sig = ev.labels == 0
    keep = D.background_activity_filter(ev.xs, ev.ys, ev.ts, 0.008,
                                        sensor_size=(48, 48), n_slices=64,
                                        device="cpu").numpy()
    np.testing.assert_array_equal(keep, np.asarray(jbaf(
        ev.xs, ev.ys, ev.ts, 0.008, sensor_size=(48, 48), n_slices=64)))
    assert keep[sig].mean() > 0.95
    assert 1 - keep[~sig].mean() > 0.6
