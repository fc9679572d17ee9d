"""Parity of the port's augmentation (``augmentation/event_augmentation.py``)
with the JAX package's, on the CPU.

- Host (numpy) ops: the same inputs and the same ``np.random.default_rng``
  seed give bit-identical arrays.
- Device ops: each core is fed JAX's own ``jax.random`` draws (split as the
  JAX function splits its key) and must give JAX's answer exactly — the
  jitter, the densify stream against every JAX sort route (packed,
  general, block, global, ``sort=False``, epoch stamps) and the remove
  mask; the rotation to 1e-5 px (its cos/sin are rounded from float64
  here, f32 in JAX). Pad slots of a densified stream (mask 0) are compared
  by mask only.
- JAX's packed word's two hazards (``ADVICE.md``): on integer inputs
  outside the word the port gives JAX's general path's answer, where JAX's
  packed word does not.
- The voxel grid of the densified stream, against JAX's, at f32 class
  (1e-5 of the grid's scale).
"""

import numpy as np
import pytest
import jax
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.augmentation import event_augmentation as JA
from event_utils_tpu_torch.augmentation import event_augmentation as PA

torch.set_num_threads(1)

CPU = "cpu"
SENSOR = (24, 32)


def events(rng, n=600, sensor=(180, 240), t0=0.0, int_coords=True):
    H, W = sensor
    if int_coords:
        xs = rng.integers(0, W, n).astype(np.int64)
        ys = rng.integers(0, H, n).astype(np.int64)
    else:
        xs = rng.uniform(0, W - 1, n)
        ys = rng.uniform(0, H - 1, n)
    ts = t0 + np.sort(rng.uniform(0, 0.5, n))
    ps = rng.choice(np.array([-1.0, 1.0]), n)
    return xs, ys, ts, ps


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g is None or np.isscalar(w) or isinstance(w, tuple):
            assert g == w
            continue
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Host (numpy) ops: bit for bit with the same seed
# ---------------------------------------------------------------------------

HOST_CASES = {
    "events_to_block": lambda m, ev, rng: m.events_to_block(*ev),
    "block_to_events": lambda m, ev, rng: m.block_to_events(
        m.events_to_block(*ev)),
    "merge_events": lambda m, ev, rng: m.merge_events([ev, ev[::-1]]),
    "merge_events sorted": lambda m, ev, rng: m.merge_events(
        [ev, [a[::-1] for a in ev]], sort=True),
    "sample": lambda m, ev, rng: (m.sample(ev[2], ev[2], rng=rng),),
    "add_random_events": lambda m, ev, rng: m.add_random_events(
        *ev, 250, rng=rng),
    "add_random_events sensor unsorted": lambda m, ev, rng:
        m.add_random_events(*ev, 250, sensor_resolution=(180, 240),
                            sort=False, rng=rng),
    "add_random_events alone": lambda m, ev, rng: m.add_random_events(
        *ev, 100, return_merged=False, rng=rng),
    "remove_events": lambda m, ev, rng: m.remove_events(*ev, 200, rng=rng),
    "remove_events noise": lambda m, ev, rng: m.remove_events(
        *ev, 200, add_noise=50, rng=rng),
    "remove_events too many": lambda m, ev, rng: m.remove_events(
        *ev, 10_000, rng=rng),
    "add_correlated_events 2x": lambda m, ev, rng: m.add_correlated_events(
        *ev, 1200, rng=rng),
    "add_correlated_events remainder": lambda m, ev, rng:
        m.add_correlated_events(*ev, 1500, add_noise=40, rng=rng),
    "add_correlated_events alone unsorted": lambda m, ev, rng:
        m.add_correlated_events(*ev, 300, sort=False, return_merged=False,
                                rng=rng),
    "flip_events_x": lambda m, ev, rng: m.flip_events_x(*ev),
    "flip_events_y": lambda m, ev, rng: m.flip_events_y(
        *ev, sensor_resolution=(200, 260)),
    "crop_events": lambda m, ev, rng: m.crop_events(
        ev[0], ev[1], (180, 240), (100, 150)),
    "rotate_events": lambda m, ev, rng: m.rotate_events(
        ev[0], ev[1], theta_radians=0.7, center_of_rotation=(100, 80)),
    "rotate_events drawn, clipped": lambda m, ev, rng: m.rotate_events(
        ev[0], ev[1], clip_to_range=True, rng=rng),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_ops_bit_for_bit(name):
    fn = HOST_CASES[name]
    ev = events(np.random.default_rng(5))
    want = fn(JA, ev, np.random.default_rng(9))
    got = fn(PA, ev, np.random.default_rng(9))
    if isinstance(want, np.ndarray):
        want, got = (want,), (got,)
    assert_same(got, want)


def test_crop_and_rotate_clip_return_numpy():
    """The port's ``clip_events_to_bounds`` keeps numpy for numpy inputs,
    as JAX's does, so ``crop_events`` and a clipped rotation stay numpy."""
    xs, ys, _, _ = events(np.random.default_rng(1))
    for out in (PA.crop_events(xs, ys, (180, 240), (90, 120)),
                PA.rotate_events(xs, ys, theta_radians=1.0,
                                 clip_to_range=True)[:2]):
        assert all(isinstance(a, np.ndarray) for a in out)


# ---------------------------------------------------------------------------
# Device cores fed JAX's draws
# ---------------------------------------------------------------------------

def jax_normals(key, n):
    """The three standard normals that ``jitter_events_jax`` draws."""
    kx, ky, kt = jax.random.split(key, 3)
    return [torch.as_tensor(np.array(jax.random.normal(k, (n,))))
            for k in (kx, ky, kt)]


@pytest.mark.parametrize("t0", [0.0, 1.6e9])
def test_jitter_core_matches_jax(t0):
    rng = np.random.default_rng(2)
    xs, ys, ts, _ = events(rng, 500, int_coords=False, t0=t0)
    key = jax.random.PRNGKey(4)
    want = JA.jitter_events_jax(key, xs, ys, ts, xy_std=1.5, ts_std=0.001)
    got = PA._jitter_core(xs, ys, ts, *jax_normals(key, 500), xy_std=1.5,
                          ts_std=0.001, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(host(g), np.asarray(w))
    if t0:  # origin restored on the host in float64: the jitter survives
        assert isinstance(got[2], np.ndarray) and got[2].dtype == np.float64
        assert 1e-4 < np.std(got[2] - ts) < 1e-2


def densify_inputs(rng, case):
    """(xs, ys, ts, ps, mask, kwargs) of one densify case."""
    n, cap = 1500, 2048
    xs = rng.integers(0, 240, cap).astype(np.int32)
    ys = rng.integers(0, 180, cap).astype(np.int32)
    ts = np.zeros(cap, np.float32)
    ts[:n] = np.sort(rng.uniform(0, 0.3, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], cap).astype(np.float32)
    mask = (np.arange(cap) < n).astype(np.float32)
    kw = dict(ts_std=0.0005)
    if case.startswith("general"):
        xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    if case.endswith("global"):
        kw["sort_block"] = None
    if case.endswith("block 64"):
        kw["sort_block"] = 64
    if case.endswith("block 16"):  # too small: the check falls back
        kw["sort_block"] = 16
    if case == "packed, interior hole":
        mask[100:200] = 0.0
    if case == "packed, no mask":
        mask = None
        ts = np.sort(rng.uniform(0, 0.3, cap))
    if case == "packed, epoch stamps":
        mask = None
        ts = 1.5e9 + np.sort(rng.uniform(0, 0.3, cap))
    if case == "unsorted":
        kw["sort"] = False
    return xs, ys, ts, ps, mask, kw


# JAX's routes (its packed word for integer coordinates, its general path
# for float ones; its row passes, a pinned block, a block that falls back,
# the global sort): the port's one stable sort gives each of their streams
DENSIFY_CASES = ["packed", "packed, global", "packed, block 64",
                 "packed, block 16", "packed, interior hole",
                 "packed, no mask", "packed, epoch stamps", "general",
                 "general, global", "general, block 64", "unsorted"]


@pytest.mark.parametrize("case", DENSIFY_CASES)
def test_densify_core_matches_jax(case):
    xs, ys, ts, ps, mask, kw = densify_inputs(np.random.default_rng(11),
                                              case)
    key = jax.random.PRNGKey(7)
    want = [np.asarray(a) for a in JA.add_correlated_events_jax(
        key, xs, ys, ts, ps, mask=mask, **kw)]
    got = [host(a) for a in PA._densify_core(
        xs, ys, ts, ps, mask, *jax_normals(key, len(ts)), device=CPU, **kw)]
    np.testing.assert_array_equal(got[4], want[4])
    valid = want[4] != 0
    if case == "unsorted":
        valid[:] = True  # no pads move: every slot is compared
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[valid], w[valid])
    ct = got[2][valid]
    if case != "unsorted":
        assert np.all(np.diff(ct) >= 0)
        assert not got[4][int(valid.sum()):].any()  # pads at the tail
    if case == "packed, epoch stamps":  # the origin restored in float64
        assert got[2].dtype == np.float64


def test_densify_epoch_stamps_keep_resolution():
    """Epoch stamps (t + 1.5e9 s): the copies keep their sub-ms jitter
    (f32 of the absolute stamp would be ~128 s coarse)."""
    rng = np.random.default_rng(3)
    xs, ys, ts, ps = events(rng, 4000, t0=1.5e9)
    gen = torch.Generator().manual_seed(0)
    cx, cy, ct, cp, cm = PA.add_correlated_events_torch(
        xs, ys, ts, ps, ts_std=0.001, generator=gen, device=CPU)
    assert ct.dtype == np.float64 and np.all(np.diff(ct) >= 0)
    # every stamp is an original or an original + N(0, 1 ms) jitter
    src = np.searchsorted(ts, ct)
    near = np.minimum(np.abs(ct - ts[np.clip(src, 0, len(ts) - 1)]),
                      np.abs(ct - ts[np.clip(src - 1, 0, len(ts) - 1)]))
    assert near.max() < 0.01
    assert len(np.unique(ct)) > 1.9 * len(ts)


def test_densify_sort_routes_agree_and_public_function_draws():
    """The public function on a CPU generator: integer and float
    coordinates, 'auto' and the global sort, give the same stream from the
    same draws."""
    rng = np.random.default_rng(8)
    xs, ys, ts, ps = events(rng, 3000)
    out = {}
    for name, (x, y, blk) in {
            "packed": (xs, ys, "auto"),
            "general": (xs.astype(np.float32), ys.astype(np.float32),
                        "auto"),
            "global": (xs, ys, None)}.items():
        gen = torch.Generator().manual_seed(5)
        out[name] = PA.add_correlated_events_torch(
            x, y, ts, ps, sort_block=blk, generator=gen, device=CPU)
    for name in ("general", "global"):
        for a, b in zip(out["packed"], out[name]):
            np.testing.assert_array_equal(host(a), host(b))


def out_of_contract(rng, hazard):
    """Integer streams outside the packed word's contract."""
    n = 1024
    xs = rng.integers(0, 240, n).astype(np.int32)
    ys = rng.integers(0, 180, n).astype(np.int32)
    ts = np.sort(rng.uniform(0, 0.3, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = np.ones(n, np.float32)
    if hazard == "coordinates":  # ADVICE.md, event_augmentation.py:404
        xs[10], ys[20], xs[30] = 20000, 16384, -3
    else:  # ADVICE.md, event_augmentation.py:401
        ps[5], ps[6], mask[7], mask[8] = 0.0, 0.5, 0.5, 2.0
    return xs, ys, ts, ps, mask


@pytest.mark.parametrize("hazard", ["coordinates", "payload"])
def test_packed_hazards_closed(hazard):
    """On integer inputs outside JAX's packed word the port's integer and
    float-coordinate calls agree, and equal JAX's general path; JAX's
    packed word corrupts the same inputs."""
    xs, ys, ts, ps, mask = out_of_contract(np.random.default_rng(4), hazard)
    key = jax.random.PRNGKey(2)
    z = jax_normals(key, len(ts))
    ints = [host(a) for a in PA._densify_core(xs, ys, ts, ps, mask, *z,
                                              device=CPU)]
    floats = [host(a) for a in PA._densify_core(
        xs.astype(np.float32), ys.astype(np.float32), ts, ps, mask, *z,
        device=CPU)]
    for a, b in zip(ints, floats):
        np.testing.assert_array_equal(a, b)
    # the port's general path is JAX's general path...
    jg = [np.asarray(a) for a in JA.add_correlated_events_jax(
        key, xs.astype(np.float32), ys.astype(np.float32), ts, ps, mask=mask)]
    for a, b in zip(ints, jg):
        np.testing.assert_array_equal(a, b)
    # ...and JAX's packed path differs from it on these inputs
    jp = [np.asarray(a) for a in JA.add_correlated_events_jax(
        key, xs, ys, ts, ps, mask=mask)]
    assert any(not np.array_equal(a, b) for a, b in zip(jp, jg))


def test_integer_coords_at_the_packed_words_edges():
    """Integer inputs at the edges of JAX's packed word (x, y = 0 and
    2^14 - 1 on a 2^14 sensor): the port's integer and float-coordinate
    calls agree, and equal JAX's packed path on the valid slots."""
    rng = np.random.default_rng(6)
    n, S = 512, 1 << 14
    xs = rng.integers(0, S, n).astype(np.int64)
    ys = rng.integers(0, S, n).astype(np.int64)
    xs[:2], ys[:2] = (0, S - 1), (S - 1, 0)
    ts = np.sort(rng.uniform(0, 0.3, n))
    ps = rng.choice([-1.0, 1.0], n)
    z = jax_normals(jax.random.PRNGKey(1), n)
    kw = dict(sensor_resolution=(S, S), device=CPU)
    a = PA._densify_core(xs, ys, ts, ps, None, *z, **kw)
    b = PA._densify_core(xs.astype(np.float32), ys.astype(np.float32), ts,
                         ps, None, *z, **kw)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(host(u), host(v))
    jp = JA.add_correlated_events_jax(jax.random.PRNGKey(1), xs, ys, ts, ps,
                                      sensor_resolution=(S, S))
    for u, v in zip(a, jp):
        np.testing.assert_array_equal(host(u), np.asarray(v))


def test_voxel_grid_of_densified_stream_matches_jax():
    """``events_to_voxel`` of the densified stream (B = 5, with its mask),
    port (the voxel kernel's route, plain on the CPU) against JAX."""
    rng = np.random.default_rng(12)
    xs, ys, ts, ps = events(rng, 3000, sensor=SENSOR)
    key = jax.random.PRNGKey(9)
    cx, cy, ct, cp, cm = JA.add_correlated_events_jax(
        key, xs, ys, ts, ps, sensor_resolution=SENSOR, ts_std=0.002)
    want = np.asarray(J.representations.events_to_voxel(
        cx, cy, ct, cp, 5, sensor_size=SENSOR, mask=cm))
    got_stream = PA._densify_core(xs, ys, ts, ps, None,
                                  *jax_normals(key, len(ts)),
                                  sensor_resolution=SENSOR, ts_std=0.002,
                                  device=CPU)
    for impl in ("matmul", None):
        got = P.representations.events_to_voxel(
            got_stream[0], got_stream[1], got_stream[2], got_stream[3], 5,
            sensor_size=SENSOR, mask=got_stream[4], impl=impl, device=CPU)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("to_remove", [0, 10, 63, 64, 100])
def test_remove_mask_core_matches_jax(to_remove):
    key = jax.random.PRNGKey(1)
    want = np.asarray(JA.remove_events_mask_jax(key, 64, to_remove))
    scores = torch.as_tensor(np.array(jax.random.uniform(key, (64,))))
    got = PA._remove_mask_core(scores, to_remove)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(to_remove)
    m = PA.remove_events_mask_torch(5000, min(to_remove * 50, 6000),
                                    generator=gen)
    assert int(m.sum()) == max(5000 - to_remove * 50, 0)


@pytest.mark.parametrize("given", [True, False])
def test_rotate_core_matches_jax(given):
    rng = np.random.default_rng(13)
    xs, ys, _, _ = events(rng, 800, sensor=SENSOR, int_coords=False)
    key = jax.random.PRNGKey(5)
    kw = dict(theta_radians=1.4, center_of_rotation=(16, 12)) if given \
        else {}
    jx, jy, theta, centre = JA.rotate_events_jax(
        key, xs, ys, sensor_resolution=SENSOR, **kw)
    theta = float(theta)
    centre = tuple(float(c) for c in centre)
    gx, gy, gt, gc = PA.rotate_events_torch(
        xs, ys, sensor_resolution=SENSOR, theta_radians=theta,
        center_of_rotation=centre, device=CPU)
    assert (gt, gc) == (theta, centre)
    assert np.abs(gx.numpy() - np.asarray(jx)).max() <= 1e-5
    assert np.abs(gy.numpy() - np.asarray(jy)).max() <= 1e-5


def test_rotate_draws_theta_and_centre_from_the_generator():
    xs = np.arange(10.0)
    a = PA.rotate_events_torch(xs, xs, generator=torch.Generator()
                               .manual_seed(3), device=CPU)
    b = PA.rotate_events_torch(xs, xs, generator=torch.Generator()
                               .manual_seed(3))
    assert 0 <= float(a[2]) < 2 * np.pi
    assert 0 <= float(a[3][0]) < 240 and 0 <= float(a[3][1]) < 180
    for u, v in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize("axis", ["x", "y"])
def test_flips_match_jax(axis):
    rng = np.random.default_rng(14)
    xs, ys, ts, ps = events(rng, 300)
    jfn = getattr(JA, f"flip_events_{axis}_jax")
    pfn = getattr(PA, f"flip_events_{axis}_torch")
    want = jfn(xs.astype(np.int32), ys.astype(np.int32), ts, ps)
    got = pfn(xs.astype(np.int32), ys.astype(np.int32), ts, ps, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(host(g), np.asarray(w))
    flipped = got[0] if axis == "x" else got[1]
    assert flipped.dtype == torch.int32


def test_device_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    xs, ys, ts, ps = events(np.random.default_rng(0), 10)
    with pytest.raises(P.errors.DeviceUnavailableError):
        PA.add_correlated_events_torch(xs, ys, ts, ps)
    with pytest.raises(P.errors.DeviceUnavailableError):
        PA.remove_events_mask_torch(10, 3)
    with pytest.raises(P.errors.DeviceUnavailableError):
        PA.rotate_events_torch(xs, ys)
    with pytest.raises(P.errors.DeviceUnavailableError):
        PA.jitter_events_torch(xs, ys, ts)
