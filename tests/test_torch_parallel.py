"""The port's multi-card path against the JAX package, on the CPU.

``tests/torch_rank_worker.py`` runs the port on 2 and on 3 ranks (gloo,
``torch.multiprocessing``, a ``file://`` store under ``tmp_path``; 3 ranks
pad every stream and the ROI axis raggedly), once per world size for the
whole module, and each rank writes what it got to an ``.npz``. Here the
results are held against ``event_utils_tpu.parallel`` on a mesh of the
same size (the conftest's virtual CPU devices) and against the port in one
process:

- voxel grids within 1e-4 (also n = 4001), the IWE within 1e-3, the
  timestamp images within 2e-5 (forward and reversed);
- two train steps with ``normalize_grad`` on and off: params and momentum
  within 1e-4, loss 1e-4 relative; with the normalisation off the
  momentum after the first step is the raw global gradient, which is large
  enough here that a gradient scaled by the world size, or reduced from
  one shard only, breaks the bound;
- ``sharded_grid_cmax``: ``grid_cmax_batched``'s contract, the per-ROI rule
  of ``tests/test_torch_roi_solvers.py`` against JAX's (1.5 px/s with
  JAX's tie rule, medians 0.5 px/s), and the one-process port's
  ``grid_cmax_batched`` to 1e-4;
- ``FlowTrainer`` data-parallel for 2 Adam steps on fixed batches from
  JAX's initial weights: the first step's gradient (DDP's mean over the
  ranks) within 1e-5 of each leaf's scale of the one-process port's and
  of JAX's gradient of the global batch's loss; losses 1e-5 relative
  against the one-process port and 1e-4 against JAX's
  ``FlowTrainer(mesh=make_mesh(2, axis_name="batch"))`` on 2 ranks; the
  weights against the one-process port by ``tests/test_torch_training.py``'s
  Adam rule (the ranks' gradient mean sums in another order, and Adam
  turns a rounding-level difference at a near-zero gradient into a share
  of the learning rate); a batch that does not divide over the ranks
  raises;
- the in-the-loop flow and reconstruction trainers: each rank simulates
  its own elements from their own draws, bit for bit the one-process
  batch's; losses and evals within 1e-5 relative of the one-process run,
  weights by the same Adam rule.

Every rank's results are the same arrays (the outputs are replicated), but
the scenes each rank simulated.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_utils_tpu.parallel as JP
from event_utils_tpu.models import linvel_warp as j_linvel
from event_utils_tpu.models import variance_objective as j_variance
from event_utils_tpu.training import FlowTrainer as JFlowTrainer
from event_utils_tpu.training.checkpointing import (
    save_params_npz as j_save_params)
from event_utils_tpu_torch import convert
from event_utils_tpu_torch.contrast_max import grid_cmax_batched
from event_utils_tpu_torch.training import (FlowTrainer,
                                            ReconstructionTrainer,
                                            train_flow_in_the_loop,
                                            train_reconstruction_in_the_loop)
from event_utils_tpu_torch.training import in_the_loop as itl

import torch_rank_worker as W
from test_torch_roi_solvers import check, jax_patch_losses
from test_torch_training import flat

WORLDS = (2, 3)
LOOP_REL = 1e-5    # losses and evals of the in-the-loop runs, ranks vs one
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def flow_init(tmp_path_factory):
    """A JAX-initialised ``FlowTrainer``'s weights as a ``params.npz``."""
    jt = JFlowTrainer(W.TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0)
    path = str(tmp_path_factory.mktemp("init") / "flow.npz")
    j_save_params(jt, path)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, flow_init):
    """``{world: [rank 0 results, rank 1 results, ...]}``: both worlds run
    at once, each in its own process tree."""
    runs = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        runs[world] = (d, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_rank_worker.py"),
             str(world), d, flow_init],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for world, (d, proc) in runs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
        out[world] = []
        for r in range(world):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                out[world].append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def inputs():
    return W.make_inputs()


def jmesh(world, axis_name="events"):
    return JP.make_mesh(world, axis_name=axis_name)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_results(ranks, world):
    first = ranks[world][0]
    for other in ranks[world][1:]:
        assert set(other) == set(first)
        for k, v in first.items():
            if not k.startswith("itl_flow_scene"):   # each rank's own
                np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,B", [("voxel", 5), ("voxel_ragged", 3)])
def test_sharded_voxel_matches_jax(ranks, inputs, world, case, B):
    ref = JP.sharded_events_to_voxel(jmesh(world), *inputs[case], B,
                                     sensor_size=W.SENSOR)
    np.testing.assert_allclose(ranks[world][0][case], np.asarray(ref),
                               atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_iwe_matches_jax(ranks, inputs, world):
    ref = JP.sharded_iwe(jmesh(world), inputs["iwe_params"], *inputs["iwe"],
                         j_linvel(), W.SENSOR)
    np.testing.assert_allclose(ranks[world][0]["iwe"], np.asarray(ref),
                               atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reverse", [False, True])
def test_sharded_timestamp_image_matches_jax(ranks, inputs, world, reverse):
    pos, neg = JP.sharded_events_to_timestamp_image(
        jmesh(world), *inputs["tsimg"], sensor_size=W.SENSOR,
        timestamp_reverse=reverse)
    got = ranks[world][0][f"tsimg_{reverse:d}"]
    np.testing.assert_allclose(got[0], np.asarray(pos), atol=2e-5)
    np.testing.assert_allclose(got[1], np.asarray(neg), atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(W.STEP_CASES))
def test_sharded_train_step_matches_jax(ranks, inputs, world, case):
    mesh = jmesh(world)
    step = JP.make_sharded_cmax_train_step(
        mesh, j_variance(), j_linvel(), W.SENSOR,
        normalize_grad=W.STEP_CASES[case])
    shards = JP.shard_events(mesh, *inputs["step"])
    p = jnp.asarray(inputs["step_params"])
    m = jnp.zeros(2)
    for i in range(W.TRAIN_STEPS):
        p, m, loss = step(p, m, *shards)
        got = ranks[world][0][f"step_{case}_{i}"]
        np.testing.assert_allclose(got[:2], np.asarray(p), atol=1e-4)
        np.testing.assert_allclose(got[2:4], np.asarray(m), atol=1e-4)
        np.testing.assert_allclose(got[4], float(loss), rtol=1e-4)
        if i == 0 and not W.STEP_CASES[case]:
            # the raw gradient, 20 times the bound above: its world-fold
            # multiple, or a share of it, would be far outside that bound
            assert np.abs(np.asarray(m)).max() > 20 * 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grid_cmax_matches_jax_and_one_process(ranks, inputs, world):
    res = ranks[world][0]
    got = [res["grid_params"], res["grid_rois"], res["grid_f"],
           res["grid_valid"]]
    assert got[1].shape == (len(got[0]), 4)
    assert set(got[1][:, 2]) == {inputs["grid_kw"]["roi_size"][0]}
    ref = [np.asarray(a) for a in JP.sharded_grid_cmax(
        jmesh(world), *inputs["grid"], **inputs["grid_kw"])]
    check(ref, got, truth=(10.0, 5.0), jax_loss=jax_patch_losses(
        inputs["grid"], j_variance(),
        inputs["grid_kw"]["roi_size"], W.SENSOR))
    one = [a.numpy() for a in grid_cmax_batched(*inputs["grid"],
                                                device="cpu",
                                                **inputs["grid_kw"])]
    np.testing.assert_allclose(got[0], one[0], atol=1e-4)
    np.testing.assert_array_equal(got[1], one[1])
    np.testing.assert_allclose(got[2], one[2], rtol=1e-4)
    np.testing.assert_array_equal(got[3], one[3])


def leaves(res: dict, prefix: str) -> dict:
    """The rank's ``prefix/`` arrays, keyed as a state dict."""
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def assert_leaves(got: dict, ref: dict, rel):
    """Every leaf within ``rel`` of its reference's scale."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(got[k] - r).max())
        assert err <= rel * scale, (k, err, scale)


def assert_adam_weights(got: dict, ref: dict, lr_sum):
    """``tests/test_torch_training.py``'s rule for weights after Adam: 99.9%
    of the coordinates within 1e-5 of the weight scale, every one within
    5% of the summed learning rate (Adam divides each coordinate's step by
    its own gradient's size, so at a near-zero gradient a rounding-level
    difference moves the coordinate by a share of the rate)."""
    assert set(got) == set(ref)
    d = np.concatenate([np.abs(got[k] - r).ravel() for k, r in ref.items()])
    scale = max(float(np.abs(r).max()) for r in ref.values())
    assert np.quantile(d, 0.999) <= 1e-5 * scale, np.quantile(d, 0.999)
    assert d.max() <= 0.05 * lr_sum, d.max()


def state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def one_process_flow(flow_init):
    """The one-process port on the same batches: losses, the first step's
    gradient, the trained weights."""
    t = FlowTrainer(W.TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0,
                    device="cpu")
    t.load_params(flow_init)
    losses, grad = [], None
    for i, batch in enumerate(W.flow_batches()):
        losses.append(t.train_batch(*batch))
        if i == 0:
            grad = {n: p.grad.numpy().copy()
                    for n, p in t.model.named_parameters()}
    return dict(losses=np.array(losses), grad=grad, weights=state(t.model))


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_flow_trainer_matches_one_process(ranks, world,
                                                        one_process_flow):
    res, ref = ranks[world][0], one_process_flow
    np.testing.assert_allclose(res["dp_losses"], ref["losses"], rtol=1e-5)
    assert_leaves(leaves(res, "dp_grad"), ref["grad"], 1e-5)
    assert_adam_weights(leaves(res, "dp"), ref["weights"],
                        W.TRAIN_STEPS * 1e-3)
    assert bool(res["dp_odd_batch_raised"])


def test_data_parallel_flow_trainer_matches_jax(ranks, flow_init):
    from event_utils_tpu.models.networks import contrast_flow_loss
    from event_utils_tpu.training.checkpointing import load_params_npz

    jt = JFlowTrainer(W.TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0,
                      mesh=jmesh(2, "batch"))
    load_params_npz(jt, flow_init)
    vox, ev, mask, gt = W.flow_batches()[0]

    def loss(p):   # the global batch's loss, as JAX's trainer forms it
        flow = jt.model.apply(p, vox)
        return contrast_flow_loss(flow, ev, mask, W.TRAIN_HW,
                                  smoothness_weight=0.5) + jnp.mean(
            jnp.linalg.norm(flow - gt, axis=1))

    jgrad = flat(jax.grad(loss)(jt.params))
    jl = [jt.train_batch(*b) for b in W.flow_batches()]
    res = ranks[2][0]
    np.testing.assert_allclose(res["dp_losses"], jl, rtol=1e-4)
    assert_leaves(convert.state_to_flax_params(
        {k: torch.as_tensor(v) for k, v in leaves(res, "dp_grad").items()}),
        jgrad, 1e-5)


@pytest.fixture(scope="module")
def one_process_loops():
    ft = FlowTrainer(W.TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0,
                     device="cpu")
    stats = {}
    fl, faee = train_flow_in_the_loop(ft, steps=W.TRAIN_STEPS, stats=stats,
                                      log_fn=lambda s: None, **W.LOOP_KW,
                                      **W.FLOW_LOOP_KW)
    rt = ReconstructionTrainer(W.TRAIN_HW, learning_rate=1e-3, burn_in=1,
                               model_kwargs=W.RECON_KW, ema_decay=0.9,
                               device="cpu")
    rl, curve = train_reconstruction_in_the_loop(
        rt, steps=2 * W.RECON_LOOP_KW["carry_segments"],
        log_fn=lambda s: None, **W.LOOP_KW, **W.RECON_LOOP_KW)
    return dict(ft=ft, flow_losses=np.array(fl), flow_aee=np.array(faee),
                flow_events=stats["events"], rt=rt,
                recon_losses=np.array(rl), recon_curve=np.array(curve))


@pytest.mark.parametrize("world", WORLDS)
def test_in_the_loop_flow_is_the_one_process_run(ranks, world,
                                                 one_process_loops):
    ev, mask, _ = itl.simulate_flow_batch(
        W.LOOP_KW["seed"], 0, W.LOOP_KW["batch_size"], W.TRAIN_HW,
        W.LOOP_KW["capacity"], burn_in=1, omega_max=6.0, s_max=0.6,
        fresh_prob=0.25, age_max=2.5, device="cpu")
    per = W.LOOP_KW["batch_size"] // world
    for r, res in enumerate(ranks[world]):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_array_equal(res["itl_flow_scene_events"],
                                      ev[rows].numpy())
        np.testing.assert_array_equal(res["itl_flow_scene_mask"],
                                      mask[rows].numpy())
    res, ref = ranks[world][0], one_process_loops
    np.testing.assert_allclose(res["itl_flow_losses"], ref["flow_losses"],
                               rtol=LOOP_REL)
    np.testing.assert_allclose(res["itl_flow_aee"], ref["flow_aee"],
                               rtol=LOOP_REL)
    np.testing.assert_allclose(float(res["itl_flow_events"]),
                               ref["flow_events"], rtol=1e-6)
    assert_adam_weights(leaves(res, "itl_flow"), state(ref["ft"].model),
                        W.TRAIN_STEPS * 1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_in_the_loop_reconstruction_is_the_one_process_run(
        ranks, world, one_process_loops):
    res, ref = ranks[world][0], one_process_loops
    np.testing.assert_allclose(res["itl_recon_losses"], ref["recon_losses"],
                               rtol=LOOP_REL)
    np.testing.assert_allclose(res["itl_recon_curve"], ref["recon_curve"],
                               rtol=LOOP_REL)
    assert_adam_weights(leaves(res, "itl_recon"),
                        state(ref["rt"].ema_model),
                        2 * W.RECON_LOOP_KW["carry_segments"] * 1e-3)
