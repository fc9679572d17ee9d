"""The port's simulator (``event_utils_tpu_torch.simulation``) against the
JAX package's, on the CPU.

- Golden ramps (``tests/test_simulation.py:34-128``): the same events in
  the same order with the same stats; stamps to 1e-6 s. XLA's and torch's
  f32 ``log`` differ by one ulp on ~14% of inputs, so a ramp whose
  crossings sit exactly on a threshold multiple (JAX's refractory and
  overflow cases: ``log(e)`` rounds to 1 in XLA and to 0.99999994, the
  nearer value, in torch) can count one crossing less: those two cases run
  here nudged off the tie (C = 0.149, ``log I`` up to 1.01).
- Scenes: ``render`` and ``flow`` to 1e-5, the wrap sampler far outside
  the texture, the resize step of ``smooth_texture`` to one f32 ulp
  (2^-23 at values below 1), the committed textures bit for bit.
- ``simulate_scene`` with JAX's texture: event counts within 0.1%, voxel
  grids per window within 1e-3 of their scale.
- Noise paths draw from ``torch.Generator``, not threefry: statistics
  within 4 sigma and the exact contracts (errors, capacity check, labels,
  chunk invariance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_utils_tpu.errors import ConfigurationError as JConfigurationError
from event_utils_tpu.simulation import esim as J
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DeviceUnavailableError)
from event_utils_tpu_torch.simulation import esim as P

EPS = 1e-3
CPU = "cpu"


def ramp_frames(l0, l1, n):
    """Frames whose log(I + eps) ramps linearly from l0 to l1."""
    return np.exp(np.linspace(l0, l1, n))[:, None, None] - EPS


def gen(seed):
    return torch.Generator().manual_seed(seed)


def assert_same_stream(j, p, atol=1e-6):
    assert len(p) == len(j)
    assert p.stats == j.stats
    np.testing.assert_array_equal(p.xs, j.xs)
    np.testing.assert_array_equal(p.ys, j.ys)
    np.testing.assert_array_equal(p.ps, j.ps)
    np.testing.assert_allclose(p.ts, j.ts, rtol=0, atol=atol)
    assert p.xs.dtype == j.xs.dtype and p.ts.dtype == j.ts.dtype


GOLDEN = {
    "positive_ramp": (ramp_frames(0.0, 1.0, 11), np.linspace(0, 1, 11),
                      dict(c_pos=0.3, c_neg=0.3, chunk=4), [0.3, 0.6, 0.9]),
    "negative_ramp_chunk2": (ramp_frames(1.0, 0.0, 11), np.linspace(0, 1, 11),
                             dict(c_pos=0.3, c_neg=0.3, chunk=2),
                             [0.3, 0.6, 0.9]),
    "negative_ramp_chunk3": (ramp_frames(1.0, 0.0, 11), np.linspace(0, 1, 11),
                             dict(c_pos=0.3, c_neg=0.3, chunk=3),
                             [0.3, 0.6, 0.9]),
    "reference_carry": (ramp_frames(0.0, 0.8, 5), np.linspace(0, 1, 5),
                        dict(c_pos=0.3, c_neg=0.3), [0.375, 0.75]),
    "refractory": (ramp_frames(0.0, 1.0, 21), np.linspace(0, 1, 21),
                   dict(c_pos=0.149, c_neg=0.149, refractory=0.25), None),
    "no_refractory": (ramp_frames(0.0, 1.0, 21), np.linspace(0, 1, 21),
                      dict(c_pos=0.149, c_neg=0.149), None),
    "overflow": (ramp_frames(0.0, 1.01, 2), [0.0, 1.0],
                 dict(c_pos=0.05, c_neg=0.05, max_events_per_pixel=4), None),
    "epoch_offset": (ramp_frames(0.0, 1.0, 11), 1.6e9 + np.linspace(0, 1, 11),
                     dict(c_pos=0.3, c_neg=0.3),
                     1.6e9 + np.array([0.3, 0.6, 0.9])),
    "zero_events": (ramp_frames(0.0, 0.1, 5), np.linspace(0, 1, 5),
                    dict(c_pos=5.0, c_neg=5.0), []),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_streams_match_jax(name):
    frames, ts, kw, want = GOLDEN[name]
    j = J.simulate_events(frames, ts, J.SimulatorConfig(**kw))
    p = P.simulate_events(frames, ts, P.SimulatorConfig(**kw), device=CPU)
    assert_same_stream(j, p)
    if want is not None:
        np.testing.assert_allclose(p.ts, want, rtol=0, atol=1e-5)


def test_golden_contracts():
    """The analytic expectations of JAX's golden cases, on the port."""
    ev = {k: P.simulate_events(f, t, P.SimulatorConfig(**kw), device=CPU)
          for k, (f, t, kw, _) in GOLDEN.items()}
    assert ev["positive_ramp"].ps.tolist() == [1.0, 1.0, 1.0]
    assert ev["negative_ramp_chunk3"].ps.tolist() == [-1.0, -1.0, -1.0]
    # refractory: fewer events, drops counted as attempts, spacing >= rho
    rho, free = ev["refractory"], ev["no_refractory"]
    assert len(free) == 6 and len(rho) < len(free)
    assert rho.stats["dropped"] >= len(free) - len(rho)
    assert np.all(np.diff(rho.ts) >= 0.25 - 1e-6)
    # 20 crossings in one interval with K = 4: 16 dropped
    assert len(ev["overflow"]) == 4 and ev["overflow"].stats["dropped"] == 16
    assert ev["zero_events"].stats == {"num_events": 0, "dropped": 0,
                                       "num_pos": 0, "num_neg": 0,
                                       "num_noise": 0}
    assert ev["zero_events"].labels is None


def test_chunking_does_not_change_the_stream():
    frames, ts = ramp_frames(1.0, 0.0, 11), np.linspace(0, 1, 11)
    outs = [P.simulate_events(frames, ts, P.SimulatorConfig(
        c_pos=0.3, c_neg=0.3, chunk=c), device=CPU) for c in (1, 2, 3, 64)]
    for ev in outs[1:]:
        np.testing.assert_array_equal(ev.ts, outs[0].ts)
        assert ev.stats == outs[0].stats


@pytest.mark.parametrize("frames, ts", [
    (ramp_frames(0.0, 1.0, 3), [0.0, 1.0]),          # length mismatch
    (ramp_frames(0.0, 1.0, 3), [0.0, 1.0, 0.5]),     # non-increasing
    (ramp_frames(0.0, 1.0, 3)[:1], [0.0]),           # single frame
])
def test_validation_errors(frames, ts):
    with pytest.raises(JConfigurationError):
        J.simulate_events(frames, ts)
    with pytest.raises(ConfigurationError):
        P.simulate_events(frames, ts, device=CPU)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    frames, ts = ramp_frames(0.0, 1.0, 3), [0.0, 0.5, 1.0]
    with pytest.raises(DeviceUnavailableError):
        P.simulate_events(frames, ts)
    with pytest.raises(DeviceUnavailableError):
        P.smooth_texture(gen(0), (8, 8))
    # a tensor that comes in keeps its device
    ev = P.simulate_events(torch.as_tensor(frames, dtype=torch.float32), ts,
                           P.SimulatorConfig(c_pos=0.3, c_neg=0.3))
    assert len(ev) == 3


# ---------------------------------------------------------------------------
# Scenes, sampler, textures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def texture():
    return np.asarray(J.smooth_texture(jax.random.PRNGKey(3), (24, 32)),
                      np.float32)


def scenes(tex):
    off = (-200.0, 300.0)  # far outside the sensor: taps wrap many periods
    return {
        "translate": (J.translating_scene(tex, (24.0, -15.0)),
                      P.translating_scene(tex, (24.0, -15.0), device=CPU)),
        "rotate": (J.rotating_scene(tex, 4.0),
                   P.rotating_scene(tex, 4.0, device=CPU)),
        "rotate_far_center": (J.rotating_scene(tex, -3.0, center=off),
                              P.rotating_scene(tex, -3.0, center=off,
                                               device=CPU)),
        "similarity": (J.affine_scene(tex, 0.35, 4.0),
                       P.affine_scene(tex, 0.35, 4.0, device=CPU)),
        "similarity_far_center": (J.affine_scene(tex, -0.5, 2.0, center=off),
                                  P.affine_scene(tex, -0.5, 2.0, center=off,
                                                 device=CPU)),
    }


@pytest.mark.parametrize("name", ["translate", "rotate", "rotate_far_center",
                                  "similarity", "similarity_far_center"])
def test_scene_render_and_flow_match_jax(texture, name):
    js, ps = scenes(texture)[name]
    np.testing.assert_array_equal(ps.params, js.params)
    assert ps.shape == js.shape
    for t in (0.0, 0.37, 2.0):
        tj = jnp.float32(t)
        np.testing.assert_allclose(ps.render(t).numpy(),
                                   np.asarray(js.render(tj)), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ps.flow(t).numpy(),
                                   np.asarray(js.flow(tj)), rtol=0, atol=1e-5)
    # a batch of times renders as the times one by one
    ts = torch.tensor([0.0, 0.37, 2.0])
    batch = ps.render(ts)
    assert batch.shape == (3,) + ps.shape
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(),
                                      ps.render(ts[i]).numpy())
    assert ps.flow(ts).shape == (3, 2) + ps.shape


def test_wrap_sampler_is_jax_index_modulo_size():
    """JAX's ``mode='wrap'`` takes taps ``index % size`` (period size),
    unlike scipy's; held against JAX far outside the texture."""
    from jax.scipy.ndimage import map_coordinates

    rng = np.random.default_rng(4)
    tex = rng.uniform(0.1, 1.0, (7, 11)).astype(np.float32)
    cy = rng.uniform(-1000, 1000, 4000).astype(np.float32)
    cx = rng.uniform(-1000, 1000, 4000).astype(np.float32)
    cy[:4] = [-7.0, 6.5, 0.0, -0.25]   # exact periods and the borders
    cx[:4] = [11.0, -11.0, 10.75, -0.5]
    want = np.asarray(map_coordinates(jnp.asarray(tex), [cy, cx], order=1,
                                      mode="wrap"))
    got = P._sample_wrap(torch.as_tensor(tex), torch.as_tensor(cy),
                         torch.as_tensor(cx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid, shape", [((2, 2), (5, 7)), ((4, 6), (40, 48)),
                                         ((8, 8), (128, 128)),
                                         ((2, 3), (32, 32))])
def test_texture_resize_matches_jax_image_resize(grid, shape):
    g = np.random.default_rng(1).uniform(size=grid).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(g), shape, "bilinear"))
    got = P._resize_bilinear(torch.as_tensor(g), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)


@pytest.mark.parametrize("seed", [91, 77])
def test_committed_textures_equal_jax_smooth_texture(seed):
    tex_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    want = np.asarray(J.smooth_texture(tex_key, (128, 128), octaves=3),
                      np.float32)
    got = P.load_texture(P.texture_path(seed), (128, 128))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_texture_checks(tmp_path):
    ok = np.full((4, 6), 0.5, np.float32)
    for bad, shape in ((ok.astype(np.float64), None), (ok, (6, 4)),
                       (ok[None], None), (ok * 0.0, None)):
        np.save(tmp_path / "t.npy", bad)
        with pytest.raises(ConfigurationError):
            P.load_texture(str(tmp_path / "t.npy"), shape)
    np.save(tmp_path / "t.npy", ok)
    np.testing.assert_array_equal(P.load_texture(str(tmp_path / "t.npy"),
                                                 (4, 6)), ok)


def test_smooth_texture_range_and_determinism():
    a = P.smooth_texture(gen(5), (40, 48), octaves=3, device=CPU)
    b = P.smooth_texture(gen(5), (40, 48), octaves=3, device=CPU)
    c = P.smooth_texture(gen(6), (40, 48), octaves=3, device=CPU)
    assert a.shape == (40, 48) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert abs(float(a.min()) - 0.1) < 1e-6 and abs(float(a.max()) - 1) < 1e-6


# ---------------------------------------------------------------------------
# Whole scenes
# ---------------------------------------------------------------------------

def window_voxels(ev, frame_ts, B, H, W):
    """(windows, B, H, W) temporally bilinear grids between frames."""
    edges = np.searchsorted(ev.ts, frame_ts)
    out = np.zeros((len(frame_ts) - 1, B, H, W))
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        ts = ev.ts[a:b]
        if len(ts) == 0:
            continue
        tn = (ts - ts[0]) / max(ts[-1] - ts[0], 1e-12) * (B - 1)
        b0 = np.floor(tn).astype(int)
        f = tn - b0
        px = ev.ys[a:b].astype(int) * W + ev.xs[a:b].astype(int)
        flat = out[i].reshape(B, -1)
        for bb, w in ((b0, 1 - f), (np.minimum(b0 + 1, B - 1), f)):
            np.add.at(flat, (bb, px), ev.ps[a:b] * w)
    return out


@pytest.mark.parametrize("scene", ["similarity", "translate"])
def test_simulate_scene_matches_jax_with_its_texture(scene):
    H, W = 40, 48
    tex_key, _ = jax.random.split(jax.random.PRNGKey(91))
    tex = np.asarray(J.smooth_texture(tex_key, (H, W), octaves=3))
    if scene == "similarity":
        js = J.affine_scene(tex, divergence=0.35, omega=4.0)
        ps = P.affine_scene(tex, divergence=0.35, omega=4.0, device=CPU)
    else:
        js = J.translating_scene(tex, (28.0, -17.0))
        ps = P.translating_scene(tex, (28.0, -17.0), device=CPU)
    jcfg = J.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    pcfg = P.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    jev, jfr, jts, jfl = J.simulate_scene(js, 0.3, 100.0, jcfg)
    pev, pfr, pts, pfl = P.simulate_scene(ps, 0.3, 100.0, pcfg)
    np.testing.assert_array_equal(pts, jts)
    np.testing.assert_allclose(pfr, jfr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pfl, jfl, rtol=0, atol=1e-5)
    assert len(jev) > 2000
    assert abs(len(pev) - len(jev)) <= 1e-3 * len(jev)
    assert abs(pev.stats["dropped"] - jev.stats["dropped"]) \
        <= 1e-3 * len(jev)
    assert np.all(np.diff(pev.ts) >= 0)
    frame_ts = np.linspace(0.0, 0.3, 4)
    jv = window_voxels(jev, frame_ts, 5, H, W)
    pv = window_voxels(pev, frame_ts, 5, H, W)
    for a, b in zip(pv, jv):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_simulate_events_device_matches_host_compaction():
    """The capacity-padded device batch against the port's host stream and
    against JAX's device batch on the same frames."""
    tex = np.asarray(J.smooth_texture(jax.random.PRNGKey(8), (24, 24),
                                      octaves=3))
    sc = J.translating_scene(tex, (30.0, 12.0))
    fts = np.linspace(0.0, 0.1, 13)
    frames = np.stack([np.asarray(sc.render(jnp.float32(t))) for t in fts])
    pcfg = P.SimulatorConfig(c_pos=0.2, c_neg=0.2)
    host = P.simulate_events(frames, fts, pcfg, device=CPU)
    cap = len(host) + 32
    ev, mask, over = P.simulate_events_device(frames, fts, cap, pcfg,
                                              return_overflow=True,
                                              device=CPU)
    ev, mask = ev.numpy(), mask.numpy()
    n = int(mask.sum())
    assert n == len(host) and int(over) == 0
    np.testing.assert_allclose(ev[:n, 2], host.ts, atol=1e-5)
    got = sorted(map(tuple, ev[:n, :2].astype(int)))
    want = sorted(zip(host.xs.astype(int), host.ys.astype(int)))
    assert got == want
    assert (mask[n:] == 0).all() and (ev[n:, [0, 1, 3]] == 0).all()
    np.testing.assert_array_equal(ev[n:, 2], ev[n - 1, 2])
    jev, jmask = J.simulate_events_device(
        frames, fts, cap, J.SimulatorConfig(c_pos=0.2, c_neg=0.2))
    assert int(np.asarray(jmask).sum()) == n
    np.testing.assert_allclose(ev, np.asarray(jev), rtol=0, atol=1e-6)
    # truncation keeps the earliest events and counts the cut exactly
    ev2, m2, over2 = P.simulate_events_device(frames, fts, 16, pcfg,
                                              return_overflow=True,
                                              device=CPU)
    assert int(m2.sum()) == 16 and int(over2) == len(host) - 16
    np.testing.assert_allclose(ev2[:, 2].numpy(), host.ts[:16], atol=1e-5)


# ---------------------------------------------------------------------------
# Noise: statistics and contracts
# ---------------------------------------------------------------------------

def test_leak_events_poisson_statistics():
    frames = np.full((101, 16, 16), 0.5, np.float32)
    fts = np.linspace(0.0, 1.0, 101)
    ev = P.simulate_events(frames, fts, P.SimulatorConfig(leak_rate_hz=5.0),
                           generator=gen(0), device=CPU)
    expected = 5.0 * 16 * 16  # rate * duration * pixels
    assert abs(len(ev) - expected) < 4 * np.sqrt(expected)
    assert np.all(ev.ps == 1.0)  # leak events are ON by construction
    assert ev.stats["num_noise"] == len(ev)
    assert ev.labels is not None and (ev.labels == 1).all()
    assert abs((ev.ts < 0.5).sum() - len(ev) / 2) < 4 * np.sqrt(len(ev) / 2)


def test_shot_noise_is_random_polarity():
    frames = np.full((51, 12, 12), 0.4, np.float32)
    fts = np.linspace(0.0, 1.0, 51)
    ev = P.simulate_events(frames, fts, P.SimulatorConfig(shot_rate_hz=10.0),
                           generator=gen(6), device=CPU)
    expected = 10.0 * 12 * 12
    assert abs(len(ev) - expected) < 4 * np.sqrt(expected)
    frac_on = (ev.ps > 0).mean()
    assert abs(frac_on - 0.5) < 4 * np.sqrt(0.25 / len(ev))


def test_hot_pixels_planted_and_dominant():
    cfg = P.SimulatorConfig(c_pos=0.25, c_neg=0.25, hot_pixel_fraction=0.05,
                            hot_pixel_rate_hz=2000.0,
                            max_noise_events_per_pixel=40)
    hot = P.hot_pixel_map(gen(9), (32, 32), cfg, device=CPU).numpy()
    n_hot = int(hot.sum())
    assert abs(n_hot - 0.05 * 1024) < 4 * np.sqrt(1024 * 0.05 * 0.95)
    frames = np.full((26, 32, 32), 0.5, np.float32)
    ev = P.simulate_events(frames, np.linspace(0.0, 0.25, 26), cfg,
                           generator=gen(9), device=CPU)
    counts = np.zeros((32, 32), int)
    np.add.at(counts, (ev.ys.astype(int), ev.xs.astype(int)), 1)
    # every event here is noise, and only hot pixels fire (no leak/shot)
    assert ev.stats["num_noise"] == len(ev) and (counts[~hot] == 0).all()
    assert counts[hot].mean() > 0.8 * 2000.0 * 0.25
    assert np.all(ev.ps == 1.0)


def test_noise_slots_cap_each_pixel_and_interval():
    """min(Poisson(rate dt), Kn): no pixel gets more than Kn noise events
    in one frame interval."""
    frames = np.full((11, 8, 8), 0.5, np.float32)
    fts = np.linspace(0.0, 0.1, 11)
    cfg = P.SimulatorConfig(leak_rate_hz=150.0, max_noise_events_per_pixel=8)
    ev = P.simulate_events(frames, fts, cfg, generator=gen(2), device=CPU)
    interval = np.minimum((ev.ts / 0.01).astype(int), 9)
    counts = np.zeros((10, 8, 8), int)
    np.add.at(counts, (interval, ev.ys.astype(int), ev.xs.astype(int)), 1)
    assert counts.max() <= 8 and counts.sum() == len(ev) > 0


def test_noise_stream_is_chunk_invariant_and_seeded():
    tex = P.smooth_texture(gen(1), (12, 16), device=CPU).numpy()
    sc = P.translating_scene(tex, (40.0, 10.0), device=CPU)
    fts = np.linspace(0.0, 0.2, 21)
    frames = sc.render(torch.as_tensor(fts, dtype=torch.float32))
    kw = dict(c_pos=0.2, c_neg=0.2, sigma_c=0.1, noise_std=0.01,
              leak_rate_hz=20.0, shot_rate_hz=5.0, hot_pixel_fraction=0.02,
              max_noise_events_per_pixel=8)
    runs = [P.simulate_events(frames, fts, P.SimulatorConfig(chunk=c, **kw),
                              generator=gen(4)) for c in (3, 64)]
    a, b = runs
    for f in ("xs", "ys", "ts", "ps", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.stats == b.stats and 0 < a.stats["num_noise"] < len(a)
    assert int((a.labels == 1).sum()) == a.stats["num_noise"]
    c = P.simulate_events(frames, fts, P.SimulatorConfig(**kw),
                          generator=gen(5))
    assert len(c) != len(a) or not np.array_equal(c.ts, a.ts)
    # device batch: the same noise events as the host stream
    ev, mask = P.simulate_events_device(frames, fts, len(a) + 8,
                                        P.SimulatorConfig(**kw),
                                        generator=gen(4))
    n = int(mask.sum())
    assert n == len(a)
    np.testing.assert_allclose(np.sort(ev[:n, 2].numpy()), a.ts, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(sigma_c=0.1), dict(noise_std=0.1),
                                dict(leak_rate_hz=1.0),
                                dict(shot_rate_hz=1.0),
                                dict(hot_pixel_fraction=0.1)])
def test_noise_options_need_a_generator(kw):
    frames, fts = ramp_frames(0.0, 1.0, 3), [0.0, 0.5, 1.0]
    with pytest.raises(JConfigurationError):
        J.simulate_events(frames, fts, J.SimulatorConfig(**kw))
    with pytest.raises(ConfigurationError):
        P.simulate_events(frames, fts, P.SimulatorConfig(**kw), device=CPU)
    with pytest.raises(ConfigurationError):
        P.simulate_events_device(frames, fts, 8, P.SimulatorConfig(**kw),
                                 device=CPU)


@pytest.mark.parametrize("kw", [dict(leak_rate_hz=-1.0),
                                dict(hot_pixel_fraction=1.5),
                                dict(leak_rate_hz=100.0,
                                     max_noise_events_per_pixel=4)])
def test_noise_config_errors_match_jax(kw):
    frames, fts = ramp_frames(0.0, 1.0, 3), [0.0, 0.5, 1.0]
    with pytest.raises(JConfigurationError) as je:
        J.simulate_events(frames, fts, J.SimulatorConfig(**kw),
                          key=jax.random.PRNGKey(0))
    with pytest.raises(ConfigurationError) as pe:
        P.simulate_events(frames, fts, P.SimulatorConfig(**kw),
                          generator=gen(0), device=CPU)
    assert str(pe.value) == str(je.value)


def test_labels_only_with_noise_and_zero_rates_keep_the_stream():
    frames = np.stack([np.full((8, 8), v, np.float32)
                       for v in (0.2, 0.9, 0.2)])
    fts = [0.0, 0.5, 1.0]
    ev = P.simulate_events(frames, fts, P.SimulatorConfig(c_pos=0.3,
                                                          c_neg=0.3),
                           device=CPU)
    assert ev.labels is None and len(ev) > 0
    base = P.simulate_events(frames, fts, P.SimulatorConfig(sigma_c=0.1),
                             generator=gen(3), device=CPU)
    same = P.simulate_events(frames, fts,
                             P.SimulatorConfig(sigma_c=0.1, leak_rate_hz=0.0,
                                               hot_pixel_fraction=0.0),
                             generator=gen(3), device=CPU)
    np.testing.assert_array_equal(base.ts, same.ts)
    assert base.labels is None
