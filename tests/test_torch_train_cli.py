"""The port's training CLIs against the JAX package, on the CPU at 32x32.

Both CLIs run through ``main`` with ``--device cpu`` from weights that JAX
initialised (``--resume_params``), for 2 steps:

- ``train_flow --simulate`` and ``train_reconstruction --simulate``: the
  port draws its own scenes (``torch.Generator``), so JAX's CLI cannot
  draw the same ones; the first step's loss is held against the JAX
  trainer's on the port's first batch (1e-4 relative);
- ``train_reconstruction`` on a recording: both packages' CLIs read the
  same memmap recording, and their losses (as printed, 4 decimals) and
  ``--params_out`` weights must agree (bounds of
  ``tests/test_torch_training.py``); the same scene as HDF5 trains as its
  memmap does.

Every ``--params_out`` is read back by JAX's ``load_params_npz`` and by a
fresh port trainer (bit-identical output). ``--data_parallel`` without
``torchrun`` (a world of one) trains as the plain run on every route.

``train_flow`` on a recording (a memmap directory, an HDF5 file, a
directory of HDF5 files) runs both packages' CLIs from the same weights:
final losses to 1e-4 relative and the ``--params_out`` weights within the
bounds above.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from event_utils_tpu.cli import train_reconstruction as j_train_recon
from event_utils_tpu.training import FlowTrainer as JFlowTrainer
from event_utils_tpu.training import ReconstructionTrainer as JRecon
from event_utils_tpu.training.checkpointing import (
    load_params_npz as j_load_params_npz, save_params_npz as j_save_params)
from event_utils_tpu_torch.cli import simulate, train_flow, \
    train_reconstruction
from event_utils_tpu_torch.training import FlowTrainer, ReconstructionTrainer
from event_utils_tpu_torch.training import in_the_loop as itl

H = W = 32
RECON_KW = {"base_features": 8, "recurrent_levels": 3, "num_res_blocks": 1}
FLOW_ARGS = ["--simulate", "--sensor", "32", "32", "--batch_size", "2",
             "--capacity", "4096", "--omega_max", "6", "--s_max", "0.6",
             "--burn_in", "1", "--fresh_prob", "0.25", "--age_max", "2.5",
             "--supervised_weight", "1.0", "--lr", "1e-3", "--lr_end",
             "1e-4", "--seed", "5", "--device", "cpu"]
RECON_ARGS = ["--lpips_weight", "0.1", "--mse_weight", "4.0", "--ema_decay",
              "0.9", "--burn_in", "1", "--lr", "1e-3", "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """``params.npz`` files of JAX-initialised trainers at 32x32."""
    d = tmp_path_factory.mktemp("init")
    flow, recon = str(d / "flow.npz"), str(d / "recon.npz")
    j_save_params(JFlowTrainer((H, W), seed=1), flow)
    j_save_params(JRecon((H, W), seed=2, model_kwargs=RECON_KW), recon)
    return flow, recon


def test_train_flow_simulate_matches_jax_on_the_first_batch(jax_init,
                                                            tmp_path):
    out, metrics = str(tmp_path / "f.npz"), str(tmp_path / "f.json")
    res = train_flow.main(FLOW_ARGS + [
        "--steps", "2", "--eval_every", "2", "--resume_params", jax_init[0],
        "--params_out", out, "--metrics_out", metrics])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert [s for s, _ in res["aee_curve"]] == [2] and res["steps"] == 2
    with open(metrics) as f:
        m = json.load(f)
    assert m["config"]["supervised_weight"] == 1.0 and len(m["losses"]) == 2

    # the JAX trainer on the port's first batch, from the same weights
    ev, mask, gt = itl.simulate_flow_batch(
        5, 0, 2, (H, W), 4096, omega_max=6.0, s_max=0.6, burn_in=1,
        fresh_prob=0.25, age_max=2.5, device="cpu")
    vox = itl.voxelize_batch(ev, mask, 5, (H, W)).numpy()
    jt = JFlowTrainer((H, W), learning_rate=1e-3, supervised_weight=1.0)
    j_load_params_npz(jt, jax_init[0])
    jl = jt.train_batch(vox, ev.numpy(), mask.numpy(), gt.numpy())
    assert abs(res["losses"][0] - jl) <= 1e-4 * abs(jl), (res["losses"], jl)

    # the snapshot: JAX reads it, and a fresh port trainer predicts alike
    jt2 = JFlowTrainer((H, W))
    assert j_load_params_npz(jt2, out) == 2
    back = FlowTrainer((H, W), device="cpu")
    assert back.load_params(out) == 2
    again = FlowTrainer((H, W), device="cpu")
    again.load_params(out)
    assert torch.equal(back.predict(vox), again.predict(vox))
    np.testing.assert_allclose(np.asarray(jt2.predict(vox)),
                               back.predict(vox).numpy(), atol=1e-3)


def test_train_flow_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck")
    base = FLOW_ARGS + ["--eval_every", "0", "--ckpt_dir", ck]
    train_flow.main(base + ["--steps", "2"])
    assert sorted(os.listdir(ck)) == ["step_2.pt"]
    res = train_flow.main(base + ["--steps", "1", "--resume"])
    assert len(res["losses"]) == 1
    assert sorted(os.listdir(ck)) == ["step_2.pt", "step_3.pt"]


def test_train_reconstruction_simulate_matches_jax_on_the_first_batch(
        jax_init, tmp_path):
    out = str(tmp_path / "r.npz")
    res = train_reconstruction.main(
        ["--simulate", "--sensor", "32", "32", "--steps", "2",
         "--batch_size", "2", "--seq_len", "3", "--carry_segments", "2",
         "--capacity", "20000", "--eval_every", "2", "--seed", "3",
         "--resume_params", jax_init[1], "--params_out", out] + RECON_ARGS)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    (step, *metrics), = res["psnr_curve"]
    assert step == 2 and np.isfinite(metrics).all()

    voxels, frames = itl.simulate_recon_batch(3, 0, 2, (H, W), 20000, 6,
                                              device="cpu")
    jt = JRecon((H, W), learning_rate=1e-3, lpips_weight=0.1,
                mse_weight=4.0, model_kwargs=RECON_KW, burn_in=1,
                ema_decay=0.9)
    j_load_params_npz(jt, jax_init[1])
    jl = jt.train_sequence(voxels[:3].numpy(), frames[:3].numpy())
    assert abs(res["losses"][0] - jl) <= 1e-4 * abs(jl), (res["losses"], jl)

    jr = JRecon((H, W), model_kwargs=RECON_KW)
    assert j_load_params_npz(jr, out) == 2
    back = ReconstructionTrainer((H, W), model_kwargs=RECON_KW,
                                 device="cpu")
    back.load_params(out)
    np.testing.assert_allclose(np.asarray(jr.reconstruct(voxels)[0]),
                               back.reconstruct(voxels)[0].numpy(),
                               atol=1e-5)


SIM_ARGS = ["--device", "cpu", "--sensor", "32", "32", "--scene",
            "translate", "--velocity", "28", "-17", "--duration", "0.6",
            "--fps", "80", "--frame_fps", "20", "--c_pos", "0.15", "--c_neg",
            "0.15", "--octaves", "3", "--seed", "77"]


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    rec = str(tmp_path_factory.mktemp("rec") / "rec32")
    simulate.main([rec] + SIM_ARGS)
    return rec


def printed_losses(text):
    return [float(x) for x in re.findall(r"step \d+ loss ([-\d.]+)", text)]


def test_train_reconstruction_on_a_recording_matches_jax_cli(
        jax_init, recording, tmp_path, capsys):
    args = ["--seq_len", "3", "--batch_size", "2", "--max_steps", "2",
            "--resume_params", jax_init[1]] + RECON_ARGS[:-2]
    jout, pout = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    j_train_recon.main([recording, "--params_out", jout] + args)
    jl = printed_losses(capsys.readouterr().out)
    res = train_reconstruction.main([recording, "--params_out", pout,
                                     "--device", "cpu"] + args)
    pl = printed_losses(capsys.readouterr().out)
    assert len(jl) == len(pl) == len(res["losses"]) == 2
    np.testing.assert_allclose(pl, jl, atol=1.5e-4)
    with np.load(jout) as j, np.load(pout) as p:
        assert set(j.files) == set(p.files) and int(p["__step__"]) == 2
        d = np.concatenate([np.abs(p[k] - j[k]).ravel() for k in j.files
                            if not k.startswith("__")])
        scale = max(float(np.abs(j[k]).max()) for k in j.files
                    if not k.startswith("__"))
    assert np.quantile(d, 0.999) <= 1e-5 * scale and d.max() <= 0.05 * 2e-3

    # --cache_windows --shuffle: the JAX package's sidecar, read back
    res = train_reconstruction.main(
        [recording, "--cache_windows", "--shuffle", "--device", "cpu"]
        + args)
    assert len(res["losses"]) == 2
    assert os.path.exists(recording + ".wincache_b5.npz")


def test_train_reconstruction_on_an_hdf5_recording(jax_init, recording,
                                                   tmp_path):
    """The same scene written as HDF5 trains as its memmap does."""
    h5 = str(tmp_path / "rec32.h5")
    simulate.main([h5] + SIM_ARGS)
    args = ["--seq_len", "3", "--batch_size", "2", "--max_steps", "1",
            "--resume_params", jax_init[1]] + RECON_ARGS
    got = train_reconstruction.main([h5] + args)["losses"]
    ref = train_reconstruction.main([recording] + args)["losses"]
    assert len(got) == 1
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.fixture(scope="module")
def h5_recordings(tmp_path_factory):
    """The recording's scene as one HDF5 file, and a directory of two HDF5
    recordings (``--num_sequences``)."""
    d = tmp_path_factory.mktemp("h5rec")
    h5 = str(d / "rec32.h5")
    simulate.main([h5] + SIM_ARGS)
    seqs = str(d / "seqs")
    simulate.main([seqs] + SIM_ARGS + ["--num_sequences", "2"])
    return h5, seqs


def final_loss(text):
    return float(re.findall(r"final loss: ([-\d.]+) over (\d+) steps",
                            text)[-1][0])


@pytest.mark.parametrize("route", ["memmap", "h5", "h5_dir"])
def test_train_flow_on_a_recording_matches_jax_cli(
        route, jax_init, recording, h5_recordings, tmp_path, capsys):
    """The file route of both CLIs from the same JAX-initialised weights:
    a shuffled memmap directory (its 7 windows make one batch, so the
    order of the windows, which JAX draws unseeded, moves only the sums'
    order), an HDF5 file (3 sequential batches) and a ChainLoader over a
    directory of two. The printed final losses and the ``--params_out``
    weights agree within the bounds of ``tests/test_torch_training.py``."""
    from event_utils_tpu.cli import train_flow as j_train_flow

    path, args = {
        "memmap": (recording, ["--batch_size", "8", "--epochs", "2"]),
        "h5": (h5_recordings[0], ["--batch_size", "3"]),
        "h5_dir": (h5_recordings[1], ["--batch_size", "3"]),
    }[route]
    args = [path, "--sensor", "32", "32", "--k", "1000", "--lr", "1e-3",
            "--resume_params", jax_init[0]] + args
    jout, pout = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    j_train_flow.main(args + ["--params_out", jout])
    jl = final_loss(capsys.readouterr().out)
    res = train_flow.main(args + ["--params_out", pout, "--device", "cpu"])
    pl = final_loss(capsys.readouterr().out)
    steps = {"memmap": 2, "h5": 3, "h5_dir": 6}[route]
    assert res["steps"] == len(res["losses"]) == steps
    assert abs(pl - jl) <= 1e-4 * abs(jl) + 1e-5, (pl, jl)
    # the events trained on: every real event of every batch, per epoch
    loader = train_flow.recording_loader(train_flow.build_parser()
                                         .parse_args(args))
    epochs = 2 if route == "memmap" else 1
    assert res["events"] == epochs * sum(
        int(np.count_nonzero(b["events_mask"])) for b in loader) > 0
    assert res["wall_s"] > 0
    with np.load(jout) as j, np.load(pout) as p:
        assert set(j.files) == set(p.files)
        assert int(p["__step__"]) == int(j["__step__"]) == steps
        d = np.concatenate([np.abs(p[k] - j[k]).ravel() for k in j.files
                            if not k.startswith("__")])
        scale = max(float(np.abs(j[k]).max()) for k in j.files
                    if not k.startswith("__"))
    assert np.quantile(d, 0.999) <= 1e-5 * scale
    assert d.max() <= 0.05 * steps * 1e-3


def test_train_flow_file_route_refusals(recording, tmp_path):
    with pytest.raises(SystemExit, match="--supervised_weight"):
        train_flow.main([recording, "--supervised_weight", "1.0",
                         "--device", "cpu"])
    with pytest.raises(SystemExit, match="neither t.npy"):
        train_flow.main([str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="path is required"):
        train_flow.main(["--device", "cpu"])


DP_CASES = {
    "flow_simulate": (train_flow, FLOW_ARGS + ["--steps", "2",
                                               "--eval_every", "2"]),
    "recon_simulate": (train_reconstruction, [
        "--simulate", "--sensor", "32", "32", "--steps", "2",
        "--batch_size", "2", "--seq_len", "3", "--carry_segments", "2",
        "--capacity", "20000", "--eval_every", "2", "--seed", "3"]
        + RECON_ARGS),
    "flow_recording": (train_flow, ["REC", "--sensor", "32", "32", "--k",
                                    "2000", "--batch_size", "1",
                                    "--device", "cpu"]),
    "recon_recording": (train_reconstruction, [
        "REC", "--seq_len", "3", "--batch_size", "2", "--max_steps",
        "2"] + RECON_ARGS),
}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_data_parallel_at_world_one_is_the_plain_run(case, jax_init,
                                                     recording, tmp_path,
                                                     capsys):
    """``--data_parallel`` without ``torchrun`` runs a world of one (JAX's
    line names it) and trains exactly as the plain run: the same losses and
    the same ``--params_out`` weights."""
    cli, argv = DP_CASES[case]
    init = jax_init[0] if cli is train_flow else jax_init[1]
    argv = [recording if a == "REC" else a for a in argv]
    argv += ["--resume_params", init]
    outs = {}
    for mode in ("plain", "dp"):
        out = str(tmp_path / f"{mode}.npz")
        extra = ["--data_parallel"] if mode == "dp" else []
        outs[mode] = cli.main(argv + extra + ["--params_out", out])
        text = capsys.readouterr().out
        assert ("data-parallel over 1 devices" in text) == (mode == "dp")
    assert len(outs["dp"]["losses"]) >= 2
    np.testing.assert_allclose(outs["dp"]["losses"], outs["plain"]["losses"],
                               rtol=1e-6)
    with np.load(tmp_path / "plain.npz") as a, \
            np.load(tmp_path / "dp.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
