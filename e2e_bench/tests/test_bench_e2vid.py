"""The ``e2vid.reconstruct`` cell on the CPU at a tiny size: its operation
count against PyTorch's own, a rehearsal of ``execute`` untraced and
traced, and planted faults that must come out not correct. One card test
runs the TF32 control at the cell's own size."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_util
import harness
import run as run_mod

CELL = "e2vid.reconstruct"
SEED = 2**31 + 17


def small_bench(tmp_path, base=8, num_events=40_000, k=2000, **traffic):
    """The cell with a recording of ``num_events``, windows of ``k``, a
    network of width ``base`` (and its parameter count) and a short
    warm-up; every chunk checked."""
    bench = bench_util.tiny_bench(
        tmp_path, [CELL], num_events=num_events,
        traffic=dict({"k": k, "warmup_max_s": 0.3, "warmup_slice_s": 0.1},
                     **traffic))
    path = os.path.join(bench.dir, "configs", "e2vid.json")
    cfg = harness.load_json(path)
    cfg["network"]["base_num_channels"] = base
    cfg["parameters"] = bench.reference("e2vid").num_parameters(
        cfg["network"])
    with open(path, "w") as f:
        json.dump(cfg, f)
    return bench


@contextlib.contextmanager
def host_profiler():
    """``torch.profiler`` on the host alone and ``synchronize`` stubbed,
    as the other rehearsals patch what they need."""
    from torch.profiler import ProfilerActivity
    real = torch.profiler.profile
    sync = torch.cuda.synchronize
    torch.profiler.profile = (lambda *a, activities=None, **kw: real(
        *a, activities=[ProfilerActivity.CPU], **kw))
    torch.cuda.synchronize = lambda *a: None
    try:
        yield
    finally:
        torch.profiler.profile = real
        torch.cuda.synchronize = sync


@pytest.mark.parametrize("base,hw", [(32, (184, 240)), (8, (32, 48))])
def test_flops_match_pytorchs_count_of_the_reference(base, hw):
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    ref = bench.reference("e2vid")
    cfg = bench.config("e2vid")
    cfg["network"]["base_num_channels"] = base
    cfg["padded"] = list(hw)
    if base == 32:
        assert ref.flops_per_window(cfg) == 40_104_345_600
    params = ref.init_params(cfg["network"], 0)
    voxel = torch.zeros(1, cfg["network"]["num_bins"], *hw)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            ref.forward(params, voxel, cfg["network"])
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"]
             .items()}
    conv = sum(v for k, v in by_op.items() if "convolution" in k)
    assert conv == ref.flops_per_window(cfg)
    assert conv == counter.get_total_flops()


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tmp_path, trace):
    """``execute`` on the CPU: correct, the end-to-end metrics untraced,
    the program's spans and counters read when traced and the registry
    left as it was."""
    from event_utils_tpu_torch.utils import profiling
    was = profiling.spans_enabled()
    bench = small_bench(tmp_path)
    with host_profiler():
        res = run_mod.execute(bench, CELL, SEED, 1.5, trace, device="cpu")
    assert res.correct, res.readings
    assert res.readings["chunks_checked"] >= 2
    assert profiling.spans_enabled() is was
    assert profiling.take().counts == {}
    if not trace:
        assert set(res.metrics) == {"events_per_s", "setup_s"}
        return
    assert {"fetch_ms.e2vid", "forward_ms.e2vid",
            "reconstruct_mfu.e2vid"} <= set(res.metrics), res.metrics


def _drop_state(real):
    def broken(self, voxels, state=None):
        return real(self, voxels, state=None)
    return broken


def _skip_window(real):
    def broken(self, index, seed=None):
        return real(self, min(index + 1, len(self) - 1) if index else 0,
                    seed)
    return broken


def _half_events(real):
    def broken(self, idx0, idx1):
        return tuple(a[::2] for a in real(self, idx0, idx1))
    return broken


def _grid_bfloat16(real):
    def broken(*args, **kwargs):
        fetch, stamps = real(*args, **kwargs)

        def rounded(lo, hi):
            voxels, gts = fetch(lo, hi)
            return (torch.from_numpy(voxels).to(torch.bfloat16).float()
                    .numpy(), gts)
        return rounded, stamps
    return broken


def plant(monkeypatch, kind):
    """Break the program as ``kind`` says: the state dropped at every
    chunk, each window's grid taken from the next window, half of each
    window's events, or every grid rounded to bfloat16 (the grid in the
    nearest precision below the configuration's)."""
    from event_utils_tpu_torch.cli import reconstruct as cli
    from event_utils_tpu_torch.data_loaders.memmap_dataset import \
        MemMapDataset
    from event_utils_tpu_torch.training.reconstruction import \
        ReconstructionTrainer
    if kind == "state_dropped":
        monkeypatch.setattr(ReconstructionTrainer, "reconstruct", _drop_state(
            ReconstructionTrainer.reconstruct))
    elif kind == "window_skipped":
        monkeypatch.setattr(MemMapDataset, "__getitem__", _skip_window(
            MemMapDataset.__getitem__))
    elif kind == "half_events":
        monkeypatch.setattr(MemMapDataset, "get_events", _half_events(
            MemMapDataset.get_events))
    else:
        assert kind == "grid_bfloat16"
        monkeypatch.setattr(cli, "_window_source", _grid_bfloat16(
            cli._window_source))


FAULTS = ["state_dropped", "window_skipped", "half_events", "grid_bfloat16"]


@pytest.mark.parametrize("kind", FAULTS)
def test_faults_are_not_correct(tmp_path, monkeypatch, kind):
    plant(monkeypatch, kind)
    bench = small_bench(tmp_path)
    res = run_mod.execute(bench, CELL, SEED, 1.0, 0, device="cpu")
    assert not res.correct, res.readings


@pytest.mark.parametrize("change", [{"base_num_channels": 16},
                                    {"num_residual_blocks": 1},
                                    {"num_encoders": 2}],
                         ids=["base_ignored", "residual_block_dropped",
                              "encoder_dropped"])
def test_a_network_other_than_the_configured_fails_setup(tmp_path,
                                                         monkeypatch,
                                                         change):
    """The program has to load the reference's weights for the configured
    network, key for key and shape for shape."""
    from event_utils_tpu_torch.models.networks import UNetRecurrent
    real = UNetRecurrent.__init__

    def built_otherwise(self, *args, **kwargs):
        real(self, *args, **dict(kwargs, **change))
    monkeypatch.setattr(UNetRecurrent, "__init__", built_otherwise)
    bench = small_bench(tmp_path)
    with pytest.raises(RuntimeError, match="state_dict"):
        run_mod.execute(bench, CELL, SEED, 1.0, 0, device="cpu")


def test_parameter_count_other_than_the_configured_fails_setup(tmp_path):
    bench = small_bench(tmp_path)
    path = os.path.join(bench.dir, "configs", "e2vid.json")
    cfg = harness.load_json(path)
    cfg["parameters"] += 1
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="parameters"):
        run_mod.execute(bench, CELL, SEED, 1.0, 0, device="cpu")


def test_sound_run_and_the_bfloat16_control(tmp_path):
    """The program as it is passes; the reference in bfloat16 in its
    place, judged by the same limits, fails at least one of them."""
    bench = small_bench(tmp_path, base=32, num_events=24_000, k=3000)
    ctx = run_mod.make_context(bench, CELL, SEED, "cpu", str(tmp_path),
                               harness.Spans())
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    drv.setup()
    drv.close()
    limits = ctx.wl["check"]["limits"]
    sound = drv.check(torch.float32)
    assert all(c["ok"] for c in harness.judge(sound, limits)), sound
    control = drv.check(torch.float32, control=torch.bfloat16)
    assert not all(c["ok"] for c in harness.judge(control, limits)), control


@pytest.mark.cuda
def test_tf32_control_fails_at_the_cells_size(tmp_path, monkeypatch):
    """On the card, at the cell's own size: the program with TF32 allowed
    (its ``no_tf32`` made a no-op, cuDNN's flag on) is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    from event_utils_tpu_torch.models import networks
    monkeypatch.setattr(networks, "no_tf32", contextlib.nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
    assert np.isfinite(res.readings["images_max_abs_diff"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FAULTS)
def test_faults_fail_at_the_cells_size(tmp_path, monkeypatch, kind):
    """On the card, at the cell's own size: each planted fault, the
    bfloat16 grid among them, fails at least one limit. The readings are
    printed, for the limits' record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    plant(monkeypatch, kind)
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    print(kind, json.dumps(res.readings))
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
