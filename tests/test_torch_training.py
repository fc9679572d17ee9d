"""Parity of the port's trainers against the JAX package's, on the CPU.

Both start from the same weights (a flax init carried into the port by
``convert``) and take the same batches. The losses' gradients in the
weights agree to 1e-5 of each leaf's scale, and Adam fed the same
gradients gives the same weights to 2e-5 of each leaf's scale (optax's
``adam`` and its cosine schedule): optax forms the bias correction ``1 -
b2**t`` in f32, where ``f32(0.999)`` leaves ``1 - b2`` 1.3e-5 off, so its
first step is 6.4e-6 shorter than the exact one torch takes in double
(7.9e-6 of a leaf's scale measured after 3 steps). Over 3 steps of
``FlowTrainer`` (the contrast loss plus the supervised AEE term, cosine
schedule) and a cold (burn-in) and a warm step of
``ReconstructionTrainer`` with a small E2VID and its EMA, the losses agree
to 1e-4 relative, and the weights, for 99.9% of the coordinates, to 1e-5
of the model's weight scale. The rest is bounded by 5% of the summed
learning rate: Adam divides each coordinate's step by its own gradient's
size, so where a gradient is near zero (1e-9, against 1e-3 for its leaf)
its f32 rounding error (26% measured) moves the coordinate by a share of
``lr`` (1.1% of the summed rate at worst measured). Then the weights files
both packages read, and the port's own checkpoint directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_utils_tpu.training import FlowTrainer as JFlowTrainer
from event_utils_tpu.training import ReconstructionTrainer as JRecon
from event_utils_tpu.training.checkpointing import (
    load_params_npz as j_load_params_npz)
from event_utils_tpu_torch import convert
from event_utils_tpu_torch.errors import ConfigurationError, \
    DataFormatError, DataNotFoundError
from event_utils_tpu_torch.training import (FlowTrainer,
                                            ReconstructionTrainer,
                                            cosine_decay_schedule)
from event_utils_tpu_torch.training import checkpointing as ck

H, W = 32, 32
LOSS_REL = 1e-4
PARAM_REL = 1e-5
RECON_KW = {"base_features": 8, "recurrent_levels": 3, "num_res_blocks": 1}


def flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}


def assert_leaves(got, ref, rel):
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(got[k] - r).max())
        assert err <= rel * scale, (k, err, scale)


def assert_params(port_model, jax_params, lr_sum):
    """Trained weights: 99.9% of the coordinates within 1e-5 of the weight
    scale, every one within 5% of the summed learning rate."""
    got = convert.state_to_flax_params(port_model.state_dict())
    ref = flat(jax_params)
    assert set(got) == set(ref)
    d = np.concatenate([np.abs(got[k] - r).ravel() for k, r in ref.items()])
    scale = max(float(np.abs(r).max()) for r in ref.values())
    assert np.quantile(d, 0.999) <= PARAM_REL * scale, np.quantile(d, 0.999)
    assert d.max() <= 0.05 * lr_sum, d.max()


def port_grads(model):
    return convert.state_to_flax_params(
        {n: p.grad for n, p in model.named_parameters()})


def flow_batches(n):
    g = np.random.default_rng(21)
    out = []
    for _ in range(n):
        B, N = 2, 800
        ev = np.stack([g.integers(0, W, (B, N)), g.integers(0, H, (B, N)),
                       np.sort(g.uniform(0, 0.1, (B, N)), 1),
                       g.choice([-1.0, 1.0], (B, N))], -1).astype(np.float32)
        mask = (g.uniform(size=(B, N)) < 0.9).astype(np.float32)
        vox = g.normal(size=(B, 10, H, W)).astype(np.float32)
        gt = (g.normal(size=(B, 2, H, W)) * 30).astype(np.float32)
        out.append((vox, ev, mask, gt))
    return out


def test_cosine_schedule_is_optax():
    ref = optax.cosine_decay_schedule(1e-3, decay_steps=7, alpha=0.05)
    got = cosine_decay_schedule(1e-3, decay_steps=7, alpha=0.05)
    for c in range(10):
        assert abs(got(c) - float(ref(c))) <= 1e-7 * 1e-3, c
    with pytest.raises(ConfigurationError):
        cosine_decay_schedule(1e-3, 0)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_flow_trainer_steps_match_jax(schedule):
    lr = 1e-3
    jlr = (optax.cosine_decay_schedule(lr, 3, alpha=0.1)
           if schedule == "cosine" else lr)
    plr = cosine_decay_schedule(lr, 3, alpha=0.1) if schedule == "cosine" \
        else lr
    jt = JFlowTrainer((H, W), learning_rate=jlr, supervised_weight=1.0)
    pt = FlowTrainer((H, W), learning_rate=plr, supervised_weight=1.0,
                     device="cpu")
    convert.load_flax_params(pt.model, flat(jt.params))
    for vox, ev, mask, gt in flow_batches(3):
        jl = jt.train_batch(vox, ev, mask, gt)
        pl = pt.train_batch(vox, ev, mask, gt)
        assert abs(pl - jl) <= LOSS_REL * abs(jl), (pl, jl)
    assert pt.step == jt.step == 3 and pt.opt.count == 3
    assert_params(pt.model, jt.params,
                  sum(pt.opt.lr(c) for c in range(3)))
    np.testing.assert_allclose(pt.predict(vox).numpy(),
                               np.asarray(jt.predict(vox)),
                               atol=PARAM_REL * 1e3, rtol=0)


def test_loss_gradients_in_the_weights_match_jax():
    from event_utils_tpu.models.networks import (contrast_flow_loss,
                                                 reconstruction_loss)

    jt = JFlowTrainer((H, W), supervised_weight=1.0)
    pt = FlowTrainer((H, W), supervised_weight=1.0, device="cpu")
    convert.load_flax_params(pt.model, flat(jt.params))
    vox, ev, mask, gt = flow_batches(1)[0]

    def jloss(p):
        f = jt.model.apply(p, jnp.asarray(vox))
        return contrast_flow_loss(f, jnp.asarray(ev), jnp.asarray(mask),
                                  (H, W)) + jnp.mean(
            jnp.linalg.norm(f - gt, axis=1))

    pt.loss(*map(torch.tensor, (vox, ev, mask, gt))).backward()
    ref = flat(jax.jit(jax.grad(jloss))(jt.params))
    assert_leaves(port_grads(pt.model), ref, 1e-5)

    jr = JRecon((H, W), model_kwargs=RECON_KW)
    pr = ReconstructionTrainer((H, W), model_kwargs=RECON_KW,
                               lpips_weight=0.1, mse_weight=4.0,
                               device="cpu")
    convert.load_flax_params(pr.model, flat(jr.params))
    v, f = recon_batch(6)

    def jseq(p):
        state, total = None, 0.0
        for t in range(3):
            pred, state = jr.model.apply(p, jnp.asarray(v[t]), state)
            if t:       # burn-in 1
                total = total + reconstruction_loss(
                    pred, jnp.asarray(f[t]), lpips_weight=0.1,
                    mse_weight=4.0)
        return total / 2

    loss, _ = pr.sequence_loss(torch.tensor(v), torch.tensor(f), burn_in=1)
    loss.backward()
    ref = flat(jax.jit(jax.grad(jseq))(jr.params))
    assert_leaves(port_grads(pr.model), ref, 1e-5)


def test_adam_from_the_same_gradients_matches_optax():
    """3 updates from gradients with entries down to 1e-12, cosine
    schedule: optax's adam and the port's give the same weights."""
    jt = JFlowTrainer((H, W))
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, 3, alpha=0.1))
    params = jt.params
    state = tx.init(params)
    pt = FlowTrainer((H, W), learning_rate=cosine_decay_schedule(
        1e-3, 3, alpha=0.1), device="cpu")
    convert.load_flax_params(pt.model, flat(params))
    g = np.random.default_rng(9)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            g.normal(size=p.shape) * 10.0 ** g.integers(-12, 0, p.shape),
            jnp.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        conv = convert.convert_flax_params(flat(grads))
        for n, p in pt.model.named_parameters():
            p.grad = conv[n].clone()
        pt.opt.step()
    assert_leaves(convert.state_to_flax_params(pt.model.state_dict()),
                  flat(params), 2e-5)


def test_flow_trainer_without_supervision_needs_no_gt():
    jt = JFlowTrainer((H, W), learning_rate=1e-3)
    pt = FlowTrainer((H, W), learning_rate=1e-3, device="cpu")
    convert.load_flax_params(pt.model, flat(jt.params))
    vox, ev, mask, _ = flow_batches(1)[0]
    jl = jt.train_batch(vox, ev, mask)
    pl = pt.train_batch(vox, ev, mask)
    assert abs(pl - jl) <= LOSS_REL * abs(jl)
    sup = FlowTrainer((H, W), supervised_weight=1.0, device="cpu")
    with pytest.raises(ConfigurationError):
        sup.train_batch(vox, ev, mask)


@pytest.fixture(scope="module")
def window_recording(tmp_path_factory):
    """A memmap recording of 12,000 random events at 32x32 over 1 s."""
    from event_utils_tpu_torch.data_formats import memmap_packager

    g = np.random.default_rng(5)
    n = 12000
    out = str(tmp_path_factory.mktemp("fit") / "mm")
    mp = memmap_packager(out)
    mp.package_events(g.integers(0, W, n), g.integers(0, H, n),
                      np.sort(g.uniform(0, 1, n)), g.choice([-1.0, 1.0], n))
    mp.add_metadata(n, 0, 0, 1.0, 0.0, 1.0, 0, 0, sensor_size=(H, W))
    return out


@pytest.mark.parametrize("combined", [False, True])
def test_fit_matches_jax_fit(window_recording, combined):
    """``fit`` over the same unshuffled loader from the same weights: the
    port voxelizes each batch in one pair of flat scatters (one when
    ``combined``), JAX vmaps a grid per window; per-step losses agree to
    LOSS_REL."""
    from event_utils_tpu.data_loaders import NativeWindowedLoader as JLoader
    from event_utils_tpu_torch.data_loaders import NativeWindowedLoader

    kw = dict(method="k_events", k=1500, batch_size=3, shuffle=False)
    jt = JFlowTrainer((H, W), combined_channels=combined, learning_rate=1e-3)
    pt = FlowTrainer((H, W), combined_channels=combined, learning_rate=1e-3,
                     device="cpu")
    convert.load_flax_params(pt.model, flat(jt.params))
    jl = jt.fit(JLoader(window_recording, **kw), epochs=2, log_every=0,
                log_fn=lambda s: None)
    logs = []
    pl = pt.fit(NativeWindowedLoader(window_recording, **kw), epochs=2,
                log_every=2, log_fn=logs.append)
    assert len(pl) == len(jl) == 6 and pt.step == jt.step == 6
    np.testing.assert_allclose(pl, jl, rtol=LOSS_REL)
    assert len(logs) == 2 and "Mev/s ingested" in logs[0]


def test_fit_saves_checkpoints_and_a_same_step_save_does_nothing(
        window_recording, tmp_path, monkeypatch):
    from event_utils_tpu_torch.data_loaders import NativeWindowedLoader

    saves = []
    real_save = ck.torch.save
    monkeypatch.setattr(ck.torch, "save",
                        lambda obj, f: saves.append(f) or real_save(obj, f))
    pt = FlowTrainer((H, W), learning_rate=1e-3, device="cpu")
    loader = NativeWindowedLoader(window_recording, k=1500, batch_size=4)
    d = str(tmp_path / "ck")
    losses = pt.fit(loader, ckpt_dir=d, ckpt_every=2, log_fn=lambda s: None)
    assert len(losses) == 2 and np.isfinite(losses).all()
    # step 2 saved inside the loop; the final save of step 2 does nothing
    assert sorted(os.listdir(d)) == ["step_2.pt"] and len(saves) == 1
    assert FlowTrainer((H, W), device="cpu").restore_checkpoint(d) == 2


def recon_batch(seed, T=3):
    g = np.random.default_rng(seed)
    return (g.normal(size=(T, 2, 10, H, W)).astype(np.float32),
            g.uniform(size=(T, 2, 1, H, W)).astype(np.float32))


@pytest.mark.parametrize("lpips,mse,ema", [(0.1, 4.0, 0.9), (0.0, 0.0, 0.0)])
def test_reconstruction_trainer_cold_warm_and_ema_match_jax(lpips, mse, ema):
    kw = dict(learning_rate=1e-3, lpips_weight=lpips, mse_weight=mse,
              model_kwargs=RECON_KW, burn_in=1, ema_decay=ema)
    jt = JRecon((H, W), **kw)
    pt = ReconstructionTrainer((H, W), device="cpu", **kw)
    convert.load_flax_params(pt.model, flat(jt.params))
    pt.reset_ema()
    vox, frames = recon_batch(1)
    jl = jt.train_sequence(vox, frames)                       # cold
    pl = pt.train_sequence(vox, frames)
    assert abs(pl - jl) <= LOSS_REL * abs(jl), (pl, jl)
    for a, b in zip(pt.final_state, jt.final_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(
            0, 3, 1, 2), atol=1e-5)   # flax state is NHWC
    vox2, frames2 = recon_batch(2)
    jl = jt.train_sequence(vox2, frames2, state0=jt.final_state)  # warm
    pl = pt.train_sequence(vox2, frames2, state0=pt.final_state)
    assert abs(pl - jl) <= LOSS_REL * abs(jl), (pl, jl)
    assert_params(pt.model, jt.params, 2e-3)
    if ema:
        assert_params(pt.ema_model, jt.ema_params, 2e-3)
    imgs, _ = pt.reconstruct(vox)
    jimgs, _ = jt.reconstruct(vox)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), atol=1e-5)
    with pytest.raises(ConfigurationError):
        pt.train_sequence(vox[:1], frames[:1])               # burn_in >= T


def test_params_npz_is_read_by_jax(tmp_path):
    """The port's snapshot (EMA weights, step, architecture) loads into the
    JAX trainers and gives the same flow and frames."""
    pf = FlowTrainer((H, W), seed=3, device="cpu")
    pf.step = 17
    path = str(tmp_path / "flow.npz")
    ck.save_params_npz(pf, path)
    jf = JFlowTrainer((H, W))
    assert j_load_params_npz(jf, path) == 17
    vox, *_ = flow_batches(1)[0]
    np.testing.assert_allclose(np.asarray(jf.predict(vox)),
                               pf.predict(vox).numpy(), atol=1e-4)

    pr = ReconstructionTrainer((H, W), model_kwargs=RECON_KW, ema_decay=0.9,
                               seed=4, device="cpu")
    v, f = recon_batch(3)
    pr.train_sequence(v, f)     # the EMA now differs from the weights
    path = str(tmp_path / "recon.npz")
    ck.save_params_npz(pr, path)
    assert not os.path.exists(path + ".tmp.npz")
    assert ck.read_model_json_npz(path) == RECON_KW
    jr = JRecon((H, W), model_kwargs=RECON_KW)
    assert j_load_params_npz(jr, path) == 1
    np.testing.assert_allclose(np.asarray(jr.reconstruct(v)[0]),
                               pr.reconstruct(v)[0].numpy(), atol=1e-5)
    # and back into a fresh port trainer: bit-identical frames, the EMA
    # re-seeded from the weights, a fresh optimiser
    back = ReconstructionTrainer((H, W), model_kwargs=RECON_KW,
                                 ema_decay=0.9, device="cpu")
    assert back.load_params(path) == 1 and back.opt.count == 0
    assert torch.equal(back.reconstruct(v)[0], pr.reconstruct(v)[0])
    with pytest.raises(DataFormatError):
        ReconstructionTrainer((H, W), device="cpu").load_params(path)


def test_checkpoint_dir_save_restore_and_same_step_noop(tmp_path):
    d = str(tmp_path / "ckpt")
    with pytest.raises(DataNotFoundError):
        ck.restore_trainer_checkpoint(
            ReconstructionTrainer((H, W), model_kwargs=RECON_KW,
                                  device="cpu"), d)
    t = ReconstructionTrainer((H, W), model_kwargs=RECON_KW, ema_decay=0.9,
                              learning_rate=1e-3, device="cpu")
    v, f = recon_batch(5)
    t.train_sequence(v, f)
    t.save_checkpoint(d)
    assert ck.read_model_config(d) == RECON_KW
    saved = os.path.join(d, "step_1.pt")
    stamp = os.stat(saved).st_mtime_ns
    t.model.Conv_0.bias.data.add_(1.0)       # same step: not saved again
    t.save_checkpoint(d)
    assert os.stat(saved).st_mtime_ns == stamp
    t.model.Conv_0.bias.data.sub_(1.0)
    t.train_sequence(v, f)
    t.save_checkpoint(d)
    r = ReconstructionTrainer((H, W), model_kwargs=RECON_KW, ema_decay=0.9,
                              learning_rate=1e-3, device="cpu")
    assert r.restore_checkpoint(d) == 2 and r.opt.count == 2
    for a, b in ((r.model, t.model), (r.ema_model, t.ema_model)):
        for (ka, pa), (kb, pb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(pa, pb)
    # resumed training continues exactly as the original would
    assert r.train_sequence(v, f) == t.train_sequence(v, f)
    assert r.restore_checkpoint(d, step=1) == 1
    with pytest.raises(DataNotFoundError):
        r.restore_checkpoint(d, step=5)
