"""The port's batched in-the-loop simulator against its one-scene calls, on
the CPU.

``simulate_events_device_batch`` runs the B scenes of a batch through one
crossing scan and one stable sort of the ``(B, slots)`` keys; a stable
sort's permutation is unique, and every operation of the scan is
elementwise, so each row must equal the public one-scene
``simulate_events_device`` on that scene's frames: events, masks and
overflow exactly (``torch.equal``, no tolerance). The batched
``simulate_flow_scenes`` and ``simulate_recon_scenes`` (one render, one
simulation, one compaction per batch) are held exactly against
``looped_flow_scenes`` / ``looped_recon_scenes`` below, which loop the
one-scene render and simulation per scene as the port did before the
batch, and a rank's ``elements`` slice of a batch exactly against the
matching rows of the whole batch. Sizes keep ``H * W`` a multiple of 16,
so the CPU's vectorised ``log``, ``sin``, ``cos`` and ``exp`` see each
scene's values at the same lane positions either way. The JAX parity of
the same functions is in ``test_torch_in_the_loop.py`` and
``test_torch_simulation.py``.
"""

import numpy as np
import pytest
import torch

from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.representations.voxel_grid import \
    events_to_neg_pos_voxel_segments
from event_utils_tpu_torch.simulation import esim
from event_utils_tpu_torch.training import in_the_loop as itl

H, W = 32, 32
CPU = "cpu"


def translating_frames(rng, v, n_frames, duration=0.1, shape=(H, W)):
    """``(F, H, W)`` frames of a random texture drifting at ``v`` px/s."""
    tex = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    fts = itl.jax_linspace(duration, n_frames)
    return itl._render_similarity(torch.as_tensor(tex), torch.as_tensor(
        np.float32(v)), 0.0, 0.0, fts), fts


def scene_batch(rng, n_frames=13):
    """Five scenes' frames: busy, one that fires nothing (a constant
    image), one whose pixels all overflow their K slots in one interval (a
    jump of the whole image), a slow one and a fast one."""
    fts = itl.jax_linspace(0.1, n_frames)
    busy, _ = translating_frames(rng, (35.0, -20.0), n_frames)
    flat = torch.full((n_frames, H, W), 0.4)
    jump = torch.full((n_frames, H, W), 0.02)
    jump[n_frames // 2:] = 0.9            # log step 3.76: 25 crossings of 0.15
    slow, _ = translating_frames(rng, (3.0, 1.0), n_frames)
    fast, _ = translating_frames(rng, (-80.0, 55.0), n_frames)
    return torch.stack([busy, flat, jump, slow, fast]), fts


def looped(frames, fts, capacity, cfg):
    rows = [esim.simulate_events_device(f, fts, capacity, cfg,
                                        return_overflow=True, device=CPU)
            for f in frames]
    return tuple(torch.stack(a) for a in zip(*rows))


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        assert torch.equal(g, w)


@pytest.mark.parametrize("cfg,capacity", [
    (dict(c_pos=0.15, c_neg=0.15), 4000),
    (dict(c_pos=0.15, c_neg=0.15), 150),          # busy scenes overflow
    (dict(c_pos=0.2, c_neg=0.1, refractory=0.02), 3000),
    (dict(c_pos=0.15, c_neg=0.15, max_events_per_pixel=2), 20000),
    (dict(c_pos=0.15, c_neg=0.15, max_events_per_pixel=1), 300_000),  # pads
])
def test_batch_rows_equal_one_scene_calls(cfg, capacity):
    frames, fts = scene_batch(np.random.default_rng(3))
    c = esim.SimulatorConfig(**cfg)
    ev, mask, over = esim.simulate_events_device_batch(frames, fts, capacity,
                                                       c, device=CPU)
    ref = looped(frames, fts, capacity, c)
    assert ev.shape == (5, capacity, 4) and mask.shape == (5, capacity)
    assert_same((ev, mask, over), ref)
    counts = mask.sum(1).long()
    assert counts[1] == 0 and (ev[1] == 0).all()        # no events: pads at 0
    assert counts[2] > 0 and (counts > 0).sum() >= 4
    if capacity == 150:
        assert (over > 0).sum() >= 3 and (counts[over > 0] == 150).all()
    if capacity == 300_000:   # fewer slots than capacity: every row padded
        assert (mask[:, -1] == 0).all()
        n = counts
        for b in range(5):
            last = ev[b, n[b] - 1, 2] if n[b] else 0.0
            assert (ev[b, n[b]:, 2] == last).all()


def test_batch_of_one_and_its_scan_state():
    """B = 1 is the one-scene call; the scan's drops are counted per scene
    (the jump scene drops the same crossings past K at every pixel, the
    constant one none)."""
    frames, fts = scene_batch(np.random.default_rng(4), n_frames=9)
    c = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    for b in range(frames.shape[0]):
        assert_same(esim.simulate_events_device_batch(frames[b:b + 1], fts,
                                                      900, c, device=CPU),
                    tuple(a[None] for a in esim.simulate_events_device(
                        frames[b], fts, 900, c, return_overflow=True,
                        device=CPU)))
    ts32 = fts.astype(np.float32)
    batch = list(esim._scan(frames, ts32, c, None))
    for b in range(frames.shape[0]):
        one = list(esim._scan(frames[b:b + 1], ts32, c, None))
        for got, want in zip(batch, one):
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                assert torch.equal(g[b:b + 1], w)
    dropped = sum(s[4] for s in batch)
    assert dropped[1] == 0 and dropped[2] > 0 and dropped[2] % (H * W) == 0


@pytest.mark.parametrize("kw", [dict(noise_std=0.01), dict(sigma_c=0.05),
                                dict(leak_rate_hz=1.0),
                                dict(shot_rate_hz=1.0),
                                dict(hot_pixel_fraction=0.1)])
def test_noise_options_refuse_a_batch(kw):
    frames, fts = scene_batch(np.random.default_rng(5), n_frames=5)
    cfg = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15,
                               max_noise_events_per_pixel=16, **kw)
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ConfigurationError, match="simulate_events_device"):
        esim.simulate_events_device_batch(frames[:2], fts, 64, cfg,
                                          generator=gen, device=CPU)
    # one scene: the one-scene call, noise and all
    ev, mask, over = esim.simulate_events_device_batch(
        frames[:1], fts, 4096, cfg,
        generator=torch.Generator().manual_seed(2), device=CPU)
    assert_same((ev[0], mask[0], over[0]), esim.simulate_events_device(
        frames[0], fts, 4096, cfg,
        generator=torch.Generator().manual_seed(2), return_overflow=True,
        device=CPU))


def test_frame_shape_errors():
    frames, fts = scene_batch(np.random.default_rng(6), n_frames=5)
    with pytest.raises(ConfigurationError):
        esim.simulate_events_device_batch(frames[0], fts, 8, device=CPU)
    with pytest.raises(ConfigurationError):
        esim.simulate_events_device_batch(frames, fts[:4], 8, device=CPU)
    with pytest.raises(ConfigurationError):
        esim.simulate_events_device(frames, fts, 8, device=CPU)


def test_batched_render_is_each_scenes_render():
    g = np.random.default_rng(7)
    tex = torch.as_tensor(g.uniform(0.1, 1.0, (3, H, W)).astype(np.float32))
    v = torch.as_tensor(g.uniform(-40, 40, (3, 2)).astype(np.float32))
    ws = torch.as_tensor(g.uniform(-5, 5, (3, 2)).astype(np.float32))
    age = torch.as_tensor(g.uniform(0, 2.5, 3).astype(np.float32))
    t = itl.jax_linspace(0.2, 17)
    got = itl._render_similarity(tex, v, ws[:, 0], ws[:, 1], t, age=age)
    assert got.shape == (3, 17, H, W)
    for b in range(3):
        assert torch.equal(got[b], itl._render_similarity(
            tex[b], v[b], ws[b, 0], ws[b, 1], t, age=age[b]))


# ---------------------------------------------------------------------------
# In-the-loop batches against the scene loop
# ---------------------------------------------------------------------------

def looped_flow_scenes(scenes, capacity, window_t=0.1, num_frames=9,
                       burn_in=0):
    """``simulate_flow_scenes`` one scene after the other, each through the
    one-scene render and ``simulate_events_device``."""
    tex_all = scenes["texture"]
    B, h, w = tex_all.shape
    cfg = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    fts = itl.jax_linspace((burn_in + 1) * window_t,
                           burn_in * (num_frames - 1) + num_frames)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32) - cy,
                            torch.arange(w, dtype=torch.float32) - cx,
                            indexing="ij")
    evs, masks, gts, sats = [], [], [], []
    for b in range(B):
        v, ws = scenes["v"][b], scenes["ws"][b]
        frames = itl._render_similarity(tex_all[b], v, ws[0], ws[1], fts,
                                        age=scenes["age"][b])
        ev, mask, overflow = esim.simulate_events_device(
            frames, fts, capacity, cfg, return_overflow=True, device=CPU)
        t_ref = np.float32(0.0)
        if burn_in:
            if bool(scenes["fresh"][b]):
                keep = ev[:, 2] < window_t
            else:
                keep = ev[:, 2] >= burn_in * window_t
                t_ref = np.float32(burn_in * window_t)
            mask = mask * keep.to(mask.dtype)
        if scenes["similarity"]:
            rx, ry = xx - v[0] * t_ref, yy - v[1] * t_ref
            gts.append(torch.stack([v[0] - ws[0] * ry + ws[1] * rx,
                                    v[1] + ws[0] * rx + ws[1] * ry]))
        else:
            gts.append(v)
        evs.append(ev)
        masks.append(mask)
        sats.append(overflow > 0)
    return tuple(torch.stack(a) for a in (evs, masks, gts, sats))


def looped_recon_scenes(scenes, capacity, seq_len, window_t=0.05, spw=4,
                        combined=False):
    """``simulate_recon_scenes`` one scene after the other; the same one
    pair of segmented scatters over all of them."""
    tex_all = scenes["texture"]
    B, h, w = tex_all.shape
    cfg = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    fts = itl.jax_linspace(seq_len * window_t, seq_len * spw + 1)
    bounds = torch.as_tensor(fts)[::spw].contiguous()
    target_idx = torch.arange(1, seq_len + 1) * spw
    evs, segs, frames_out, sats = [], [], [], []
    for b in range(B):
        ws = scenes["ws"][b]
        frames = itl._render_similarity(tex_all[b], scenes["v"][b], ws[0],
                                        ws[1], fts)
        ev, mask, overflow = esim.simulate_events_device(
            frames, fts, capacity, cfg, return_overflow=True, device=CPU)
        wi = torch.searchsorted(bounds, ev[:, 2].contiguous()) - 1
        segs.append(torch.where((mask > 0) & (wi >= 0) & (wi < seq_len),
                                wi * B + b, -1))
        evs.append(ev)
        frames_out.append(frames[target_idx])
        sats.append(overflow > 0)
    x, y, ts, p = torch.cat(evs).unbind(-1)
    voxels = events_to_neg_pos_voxel_segments(
        x, y, ts, p, torch.cat(segs), seq_len * B, 5, (h, w),
        combined=combined)
    return (voxels.view((seq_len, B) + voxels.shape[1:]),
            torch.stack(frames_out, 1)[:, :, None], torch.stack(sats))


FLOW_CASES = {
    "translation": (dict(), 0),
    "similarity_burn_in": (dict(omega_max=6.0, s_max=0.6, age_max=2.5,
                                fresh_prob=0.5), 1),
}


@pytest.mark.parametrize("family", list(FLOW_CASES))
@pytest.mark.parametrize("capacity", [2500, 400])
def test_flow_batch_equals_the_scene_loop(family, capacity):
    kw, burn_in = FLOW_CASES[family]
    scenes = itl.draw_scenes(2, 9, 5, (H, W), **kw)
    if burn_in:   # mixed fresh and steady scenes, with ages
        assert scenes["fresh"].any() and not scenes["fresh"].all()
        assert (scenes["age"] > 0).all()
    got = itl.simulate_flow_scenes(scenes, capacity, burn_in=burn_in,
                                   num_frames=9, return_saturation=True,
                                   device=CPU)
    want = looped_flow_scenes(scenes, capacity, num_frames=9,
                              burn_in=burn_in)
    assert_same(got, want)
    assert got[2].shape == ((5, 2, H, W) if burn_in else (5, 2))
    if capacity == 400:
        assert got[3].any()


@pytest.mark.parametrize("family", ["translation", "similarity"])
@pytest.mark.parametrize("combined", [False, True])
def test_recon_batch_equals_the_scene_loop(family, combined):
    kw = dict(omega_max=4.0, s_max=0.3) if family == "similarity" else {}
    scenes = itl.draw_scenes(5, 2, 3, (H, W), **kw)
    got = itl.simulate_recon_scenes(scenes, 5000, 3, combined=combined,
                                    return_saturation=True, device=CPU)
    want = looped_recon_scenes(scenes, 5000, 3, combined=combined)
    assert got[0].shape == (3, 3, 5 if combined else 10, H, W)
    assert got[1].shape == (3, 3, 1, H, W) and got[1].is_contiguous()
    assert_same(got, want)
    assert got[0].abs().sum() > 0


@pytest.mark.parametrize("which", ["flow", "recon"])
def test_element_slice_is_the_batch_rows(which):
    """A rank's ``elements`` of a batch: the matching rows of the batch
    simulated whole."""
    kw = dict(omega_max=6.0, s_max=0.6)
    if which == "flow":
        full = itl.simulate_flow_batch(4, 3, 5, (H, W), 2000, num_frames=9,
                                       burn_in=1, fresh_prob=0.5,
                                       age_max=2.5, return_saturation=True,
                                       device=CPU, **kw)
        part = itl.simulate_flow_batch(4, 3, 5, (H, W), 2000, num_frames=9,
                                       burn_in=1, fresh_prob=0.5,
                                       age_max=2.5, return_saturation=True,
                                       elements=range(1, 3), device=CPU,
                                       **kw)
        assert_same(part, tuple(a[1:3] for a in full))
    else:
        full = itl.simulate_recon_batch(4, 3, 4, (H, W), 4000, 2,
                                        return_saturation=True, device=CPU,
                                        **kw)
        part = itl.simulate_recon_batch(4, 3, 4, (H, W), 4000, 2,
                                        return_saturation=True,
                                        elements=range(2, 4), device=CPU,
                                        **kw)
        assert_same(part, (full[0][:, 2:4], full[1][:, 2:4], full[2][2:4]))
