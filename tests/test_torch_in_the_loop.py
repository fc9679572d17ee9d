"""Parity of the port's in-the-loop batches against the JAX package, on the
CPU.

The port draws training scenes from a ``torch.Generator``, so batches are
compared from the same scene parameters: JAX's draws for a key are taken
out here (``jax_scenes``, the draws of ``simulate_flow_batch``'s
``one(k)``) and handed to the port's ``simulate_*_scenes``. From equal
parameters the kept events are the same (pixels, polarities and counts;
near-simultaneous ones may swap places), the ground-truth field agrees to
1e-6 of its scale and the voxel grids of the same events to 1e-5. The
stamps agree to 1e-5 s, not to f32 rounding: a crossing's time is ``(level
- L0) / (L1 - L0)`` of its frame interval, and where the log intensity
barely changes over the interval, the f32 rounding of the render
(``sin``/``cos``/``exp`` of torch against XLA's) moves it by up to ~1e-5 s
(7.6e-6 s measured). So the grids of the simulated events agree to 1e-5 in
L1 (2e-6 measured) and to 1e-4 of their scale at the worst bin (5e-5
measured). The committed eval-scene files must equal JAX's draws bit for
bit, and the flow eval batch rebuilt from them must give JAX's per-scene
counts and, with the committed weights, JAX's AEE
(``training/data/eval_anchors.json``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_utils_tpu.representations.voxel_grid import (
    events_to_neg_pos_voxel as j_neg_pos, events_to_voxel as j_voxel)
from event_utils_tpu.simulation.esim import smooth_texture as j_texture
from event_utils_tpu.training import in_the_loop as jitl
from event_utils_tpu_torch.representations import (
    events_to_neg_pos_voxel, events_to_voxel_segments)
from event_utils_tpu_torch.training import FlowTrainer
from event_utils_tpu_torch.training import in_the_loop as itl

H, W = 32, 32


def assert_rel(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


def jax_scenes(key, batch_size, shape, v_max=40.0, omega_max=0.0, s_max=0.0,
               age_max=0.0, fresh_prob=0.0, burn_in=0):
    """The scene parameters JAX's in-the-loop batches draw from ``key``, in
    the port's ``draw_scenes`` layout."""
    similarity = bool(omega_max or s_max)

    def one(k):
        if similarity:
            k_tex, k_vel, k_rot, _ = jax.random.split(k, 4)
            ws = jax.random.uniform(k_rot, (2,), minval=-1.0, maxval=1.0) \
                * jnp.asarray([omega_max, s_max], jnp.float32)
        else:
            k_tex, k_vel, _ = jax.random.split(k, 3)
            ws = jnp.zeros(2, jnp.float32)
        tex = j_texture(k_tex, shape, octaves=3)
        v = jax.random.uniform(k_vel, (2,), minval=-v_max, maxval=v_max)
        age = (jax.random.uniform(jax.random.fold_in(k, 23), maxval=age_max)
               if age_max else jnp.float32(0.0))
        fresh = (jax.random.uniform(jax.random.fold_in(k, 17)) < fresh_prob
                 if burn_in and fresh_prob else jnp.asarray(False))
        return tex, v, ws, age, fresh

    out = jax.jit(jax.vmap(one))(jax.random.split(key, batch_size))
    scenes = {k: torch.as_tensor(np.array(a)) for k, a in
              zip(("texture", "v", "ws", "age", "fresh"), out)}
    scenes["similarity"] = similarity
    return scenes


@pytest.mark.parametrize("stop,num", [(0.2, 17), (1.2, 97), (0.4, 33),
                                      (0.15, 13), (0.1, 9)])
def test_frame_stamps_are_jax_linspace_bit_for_bit(stop, num):
    np.testing.assert_array_equal(itl.jax_linspace(stop, num),
                                  np.asarray(jnp.linspace(0.0, stop, num)))


@pytest.mark.parametrize("age", [0.0, 1.7])
def test_similarity_render_matches_jax(age):
    g = np.random.default_rng(5)
    tex = g.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    v = np.float32([23.0, -31.0])
    omega, s = np.float32(4.5), np.float32(-0.4)
    t = itl.jax_linspace(0.2, 17)
    ref = jax.vmap(lambda tt: jitl._render_similarity(
        jnp.asarray(tex), jnp.asarray(v), omega, s, tt, age=age))(
            jnp.asarray(t))
    got = itl._render_similarity(torch.as_tensor(tex), torch.as_tensor(v),
                                 omega, s, t, age=age)
    assert_rel(got, ref, 1e-5)
    trans = jax.vmap(lambda tt: jitl._render_translating(
        jnp.asarray(tex), jnp.asarray(v), tt))(jnp.asarray(t))
    assert_rel(itl._render_translating(torch.as_tensor(tex),
                                       torch.as_tensor(v), t), trans, 1e-5)


def jax_voxels(ev, mask, combined=False):
    def one(e, m):
        x, y, t, p = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        if combined:
            return j_voxel(x, y, t, p, 5, sensor_size=(H, W), mask=m)
        vp, vn = j_neg_pos(x, y, t, p, 5, sensor_size=(H, W), mask=m)
        return jnp.concatenate([vp, vn], 0)
    return jax.vmap(one)(ev, mask)


@pytest.mark.parametrize("family", ["similarity", "translation"])
def test_flow_batch_from_jax_scene_parameters_matches_jax(family):
    sim = family == "similarity"
    cfg = dict(v_max=40.0, omega_max=6.0 if sim else 0.0,
               s_max=0.6 if sim else 0.0, age_max=2.5 if sim else 0.0,
               fresh_prob=0.5 if sim else 0.0, burn_in=1)
    key = jax.random.PRNGKey(11)
    ev, mask, gt, sat = jitl.simulate_flow_batch(
        key, 4, (H, W), 3000, return_saturation=True, **cfg)
    scenes = jax_scenes(key, 4, (H, W), **cfg)
    if sim:
        assert scenes["fresh"].any() and not scenes["fresh"].all()
    pev, pmask, pgt, psat = itl.simulate_flow_scenes(
        scenes, 3000, burn_in=1, return_saturation=True, device="cpu")
    np.testing.assert_array_equal(pmask.sum(1).numpy(),
                                  np.asarray(mask.sum(1)))
    np.testing.assert_array_equal(psat.numpy(), np.asarray(sat))
    ev, mask = np.asarray(ev), np.asarray(mask)
    for b in range(4):
        # the kept events: equal up to the order of near-simultaneous ones
        got, ref = (e[m > 0] for e, m in ((pev[b].numpy(), pmask[b].numpy()),
                                          (ev[b], mask[b])))
        got, ref = (e[np.lexsort((e[:, 2], e[:, 3], e[:, 1], e[:, 0]))]
                    for e in (got, ref))
        np.testing.assert_array_equal(got[:, [0, 1, 3]], ref[:, [0, 1, 3]])
        assert np.abs(got[:, 2] - ref[:, 2]).max(initial=0.0) <= 1e-5
    assert pgt.shape == gt.shape
    assert_rel(pgt, gt, 1e-6)
    for combined in (False, True):
        ref = np.asarray(jax_voxels(ev, mask, combined))
        assert_rel(itl.voxelize_batch(torch.tensor(ev), pmask, 5, (H, W),
                                      combined), ref, 1e-5)
        got = itl.voxelize_batch(pev, pmask, 5, (H, W), combined).numpy()
        assert np.abs(got - ref).sum() <= 1e-5 * np.abs(ref).sum()
        assert_rel(got, ref, 1e-4)


@pytest.mark.parametrize("family", ["translation", "similarity"])
def test_recon_batch_from_jax_scene_parameters_matches_jax(family):
    sim = family == "similarity"
    cfg = dict(v_max=40.0, omega_max=4.0 if sim else 0.0,
               s_max=0.3 if sim else 0.0)
    key = jax.random.PRNGKey(12)
    voxels, frames, sat = jitl.simulate_recon_batch(
        key, 2, (H, W), 6000, 3, return_saturation=True, **cfg)
    scenes = jax_scenes(key, 2, (H, W), **cfg)
    pv, pf, psat = itl.simulate_recon_scenes(scenes, 6000, 3,
                                             return_saturation=True,
                                             device="cpu")
    voxels = np.asarray(voxels)
    # every event of a window weighs 1 over its bins: equal counts
    np.testing.assert_array_equal(pv.sum((2, 3, 4)).round().numpy(),
                                  voxels.sum((2, 3, 4)).round())
    assert np.abs(pv.numpy() - voxels).sum() <= 1e-5 * np.abs(voxels).sum()
    assert_rel(pv, voxels, 1e-4)
    assert_rel(pf, frames, 1e-5)   # the renders (see the render test)
    np.testing.assert_array_equal(psat.numpy(), np.asarray(sat))


def test_segmented_voxel_grids_match_one_grid_per_window():
    """Each window of ``events_to_voxel_segments`` is the grid of its own
    events; dropped and out-of-range segment ids scatter nowhere."""
    g = np.random.default_rng(8)
    n = 3000
    xs = torch.as_tensor(g.integers(-2, W + 2, n), dtype=torch.float32)
    ys = torch.as_tensor(g.integers(-2, H + 2, n), dtype=torch.float32)
    ts = torch.as_tensor(np.sort(g.uniform(0, 1, n)), dtype=torch.float32)
    ps = torch.as_tensor(g.choice([-1.0, 1.0], n), dtype=torch.float32)
    seg = torch.as_tensor(g.integers(-1, 6, n))     # 5 windows, 5 dropped
    grids = []
    for s in range(5):
        m = seg == s
        vp, vn = events_to_neg_pos_voxel(xs[m], ys[m], ts[m], ps[m], 4,
                                         sensor_size=(H, W))
        grids.append(torch.cat([vp, vn]))
    got = itl.events_to_neg_pos_voxel_segments(xs, ys, ts, ps, seg, 5, 4,
                                               (H, W))
    assert_rel(got, torch.stack(grids), 1e-6)
    one = events_to_voxel_segments(xs, ys, ts, ps, torch.zeros(n), 1, 4,
                                   (H, W))
    assert one.shape == (1, 4, H, W)


def test_scene_draws_are_seeded_per_run_step_and_element():
    a = itl.draw_scenes(3, 5, 2, (H, W), omega_max=6.0, s_max=0.6,
                        age_max=2.5, fresh_prob=0.5)
    b = itl.draw_scenes(3, 5, 3, (H, W), omega_max=6.0, s_max=0.6,
                        age_max=2.5, fresh_prob=0.5)
    for k in ("texture", "v", "ws", "age", "fresh"):
        assert torch.equal(a[k], b[k][:2]), k
        assert a[k].device.type == "cpu"
    c = itl.draw_scenes(3, 6, 2, (H, W), omega_max=6.0, s_max=0.6)
    d = itl.draw_scenes(4, 5, 2, (H, W), omega_max=6.0, s_max=0.6)
    assert not torch.equal(a["texture"], c["texture"])
    assert not torch.equal(a["texture"], d["texture"])
    assert a["similarity"] and (a["v"].abs() <= 40).all()
    assert (a["ws"][:, 0].abs() <= 6).all() and (a["ws"][:, 1].abs()
                                                  <= 0.6).all()
    t = itl.draw_scenes(3, 5, 2, (H, W))
    assert not t["similarity"] and not t["ws"].any() and not t["age"].any()


def eval_scene_draws(batch_size, v_max, omega_max, s_max):
    _, k_eval = jax.random.split(jax.random.PRNGKey(0))
    return jax_scenes(k_eval, batch_size, (128, 128), v_max=v_max,
                      omega_max=omega_max, s_max=s_max)


@pytest.mark.parametrize("which", ["flow", "recon"])
def test_committed_eval_scenes_are_jax_draws_bit_for_bit(which):
    with open(itl.EVAL_ANCHORS) as f:
        cfg = json.load(f)[which]["config"]
    ref = eval_scene_draws(cfg["batch_size"], cfg["v_max"],
                           cfg.get("omega_max", 0.0), cfg.get("s_max", 0.0))
    got = itl.load_scenes(itl.FLOW_EVAL_SCENES if which == "flow"
                          else itl.RECON_EVAL_SCENES)
    for k in ("texture", "v", "ws"):
        assert torch.equal(got[k], ref[k]), k
    assert got["similarity"] == (which == "flow")


def test_committed_flow_eval_batch_gives_jax_counts_and_aee():
    """Stage 9's eval batch rebuilt on the CPU at full size: JAX's kept
    event count of every scene, and with the committed weights JAX's
    held-out AEE and zero-flow baseline."""
    with open(itl.EVAL_ANCHORS) as f:
        a = json.load(f)["flow"]
    cfg = a["config"]
    ev, mask, gt, sat = itl.simulate_flow_scenes(
        itl.load_scenes(itl.FLOW_EVAL_SCENES), cfg["capacity"],
        window_t=cfg["window_t"], num_frames=cfg["num_frames"],
        burn_in=cfg["burn_in"], return_saturation=True, device="cpu")
    assert mask.sum(1).long().tolist() == a["events"]
    assert sat.tolist() == a["saturated"]
    trainer = FlowTrainer((128, 128), device="cpu")
    trainer.load_params(itl.os.path.join(
        itl.os.path.dirname(itl.os.path.dirname(itl.DATA_DIR)), "..",
        a["params"]))
    aee, zero = itl.flow_eval(trainer, itl.voxelize_batch(
        ev, mask, 5, (128, 128)), gt)
    assert abs(aee - a["aee_px_s"]) <= 1e-4 * a["aee_px_s"], aee
    assert abs(zero - a["zero_flow_aee_px_s"]) <= 1e-5 * zero, zero
