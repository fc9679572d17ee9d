"""The ``eraft-dsec.flow-pairs`` cell on the CPU at a tiny size: its
operation count against PyTorch's own, a rehearsal of ``execute`` untraced
and traced, a network or parameter count other than the configured failing
set-up, and planted faults that must come out not correct. Card tests run
the TF32 control and the faults at the cell's own size.

The tiny size: a 128x128 sensor (the least that four pyramid levels
take), 8 windows of 16,384 events (one a pixel), chunks of 3 pairs and 3
refinements, at the published widths."""

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
from test_bench_e2vid import host_profiler

CELL = "eraft-dsec.flow-pairs"
CONFIG = "eraft-dsec"
SEED = 2**31 + 29


def small_bench(tmp_path, **traffic):
    """The cell at the tiny size, every chunk checked, one warm pass."""
    bench = bench_util.tiny_bench(
        tmp_path, [CELL], num_events=8 * 16384,
        traffic=dict({"k": 16384, "chunk": 3, "warmup_passes": 1},
                     **traffic))
    path = os.path.join(bench.dir, "configs", CONFIG + ".json")
    cfg = harness.load_json(path)
    cfg["sensor"] = cfg["padded"] = [128, 128]
    cfg["scene"]["points"] = 150
    cfg["network"].update(iters=3)
    cfg["parameters"] = bench.reference(CONFIG).num_parameters(
        cfg["network"])
    with open(path, "w") as f:
        json.dump(cfg, f)
    return bench


def cell_bench():
    return harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("hw,levels", [((480, 640), 4), ((32, 48), 2)])
def test_flops_match_pytorchs_count_of_the_reference(hw, levels):
    bench = cell_bench()
    ref = bench.reference(CONFIG)
    cfg = bench.config(CONFIG)
    cfg["padded"] = list(hw)
    net = dict(cfg["network"], corr_levels=levels)
    cfg["network"] = net
    if hw == (480, 640):
        assert ref.flops_per_pair(cfg) == 513_618_739_200
    params = {k: v.to("meta") for k, v in ref.init_params(net, 0).items()}
    x = torch.zeros(1, net["num_bins"], *hw, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(params, x, x, net)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"]
             .items()}
    conv = sum(v for k, v in by_op.items() if "convolution" in k)
    corr = sum(v for k, v in by_op.items() if "bmm" in k or "mm" in k
               and "convolution" not in k)
    assert conv + corr == ref.flops_per_pair(cfg)
    assert conv + corr == counter.get_total_flops()
    hw8 = hw[0] // 8 * (hw[1] // 8)
    assert corr == 2 * hw8 * hw8 * net["feature_dim"]


def test_the_configuration_is_erafts():
    bench = cell_bench()
    cfg = bench.config(CONFIG)
    ref = bench.reference(CONFIG)
    assert ref.num_parameters(cfg["network"]) == cfg["parameters"] \
        == 5_332_800
    assert cfg["sensor"] == cfg["padded"] == [480, 640]
    assert cfg["num_events"] // bench.workload(CELL)["traffic"]["k"] == 54


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tmp_path, trace):
    """``execute`` on the CPU: correct, the end-to-end metrics untraced,
    the program's spans and counters read when traced and the registry
    left as it was."""
    from event_utils_tpu_torch.utils import profiling
    was = profiling.spans_enabled()
    bench = small_bench(tmp_path)
    with host_profiler():
        res = run_mod.execute(bench, CELL, SEED, 6.0, trace, device="cpu")
    assert res.correct, res.readings
    assert res.readings["chunks_checked"] >= 3
    assert profiling.spans_enabled() is was
    assert profiling.take().counts == {}
    if not trace:
        assert set(res.metrics) == {"events_per_s", "setup_s"}
        return
    assert {"fetch_ms.eraft", "forward_ms.eraft",
            "eraft_mfu.eraft"} <= set(res.metrics), res.metrics


def test_each_window_is_built_once_a_pass(tmp_path):
    """A pass of 7 pairs in chunks of 3 builds its 8 grids once; the next
    pass starts cold and builds them again."""
    bench = small_bench(tmp_path)
    ctx = run_mod.make_context(bench, CELL, SEED, "cpu", str(tmp_path),
                               harness.Spans(enabled=True))
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    drv.setup()
    while drv.pos:
        drv.step()
    recs = [drv.step() for _ in range(6)]
    drv.close()
    assert [r["windows"] for r in recs] == [3, 3, 1, 3, 3, 1]
    built = [r["program"]["counts"]["reconstruct.batched_windows"]
             for r in recs]
    assert built == [4, 3, 1, 4, 3, 1]
    pairs = [r["program"]["counts"]["eraft.pairs"] for r in recs]
    assert pairs == [3, 3, 1, 3, 3, 1]
    assert all(r["program"]["counts"]["eraft.iterations"] == 3 * p
               for r, p in zip(recs, pairs))


def test_warm_up_is_whole_passes(tmp_path):
    """Set-up runs the cold first chunk, the rest of its pass and
    ``warmup_passes`` whole passes more, and ends on a pass's start."""
    bench = small_bench(tmp_path, warmup_passes=2)
    ctx = run_mod.make_context(bench, CELL, SEED, "cpu", str(tmp_path),
                               harness.Spans(enabled=False))
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    steps, real = [], drv.step
    drv.step = lambda: steps.append(real()) or steps[-1]
    drv.setup()
    drv.close()
    assert [r["windows"] for r in steps] == [3, 3, 1] * 3
    assert drv.pos == 0


def _swap_pairs(real):
    def broken(self, prev, cur):
        return real(self, cur, prev)
    return broken


def _context_from_the_earlier(real):
    def broken(self, image1, image2):
        fmap1, fmap2, _, _ = real(self, image1, image2)
        return (fmap1, fmap2) + real(self, image1, image1)[2:]
    return broken


def _one_iteration_fewer(real):
    def broken(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.iters -= 1
    return broken


def _last_level_dropped(real):
    def broken(self, fmap1, fmap2):
        pyramid = real(self, fmap1, fmap2)
        return pyramid[:-1] + [torch.zeros_like(pyramid[-1])]
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
    """Break the program as ``kind`` says: each pair's grids swapped, the
    context encoder fed the earlier grid, one refinement fewer, the
    pyramid's coarsest level zeroed, half of each window's events, or
    every grid rounded to bfloat16 (the grid in the nearest precision
    below the configuration's)."""
    from event_utils_tpu_torch.cli import reconstruct as cli
    from event_utils_tpu_torch.data_loaders.memmap_dataset import \
        MemMapDataset
    from event_utils_tpu_torch.models.eraft import ERAFT
    from event_utils_tpu_torch.training.loop import FlowTrainer
    patches = {
        "pair_swapped": (FlowTrainer, "predict_pairs", _swap_pairs),
        "context_from_the_earlier": (ERAFT, "encode",
                                     _context_from_the_earlier),
        "one_iteration_fewer": (ERAFT, "__init__", _one_iteration_fewer),
        "level_dropped": (ERAFT, "correlation", _last_level_dropped),
        "half_events": (MemMapDataset, "get_events", _half_events),
        "grid_bfloat16": (cli, "_window_source", _grid_bfloat16)}
    owner, name, wrap = patches[kind]
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))


FAULTS = ["pair_swapped", "context_from_the_earlier", "one_iteration_fewer",
          "level_dropped", "half_events", "grid_bfloat16"]


@pytest.mark.parametrize("kind", FAULTS)
def test_faults_are_not_correct(tmp_path, monkeypatch, kind):
    plant(monkeypatch, kind)
    bench = small_bench(tmp_path)
    res = run_mod.execute(bench, CELL, SEED, 0.5, 0, device="cpu")
    assert not res.correct, res.readings


@pytest.mark.parametrize("name,value", [("HIDDEN_DIM", 96),
                                        ("FEATURE_DIM", 128),
                                        ("CORR_RADIUS", 3)],
                         ids=["hidden_width", "feature_width",
                              "lookup_radius"])
def test_a_network_other_than_the_configured_fails_setup(tmp_path,
                                                         monkeypatch,
                                                         name, value):
    """The program has to load the reference's weights for the configured
    network, key for key and shape for shape."""
    from event_utils_tpu_torch.models import eraft
    monkeypatch.setattr(eraft, name, value)
    bench = small_bench(tmp_path)
    with pytest.raises(RuntimeError, match="state_dict"):
        run_mod.execute(bench, CELL, SEED, 1.0, 0, device="cpu")


def test_parameter_count_other_than_the_configured_fails_setup(tmp_path):
    bench = small_bench(tmp_path)
    path = os.path.join(bench.dir, "configs", CONFIG + ".json")
    cfg = harness.load_json(path)
    cfg["parameters"] += 1
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="parameters"):
        run_mod.execute(bench, CELL, SEED, 1.0, 0, device="cpu")


def test_sound_run_and_the_bfloat16_control(tmp_path):
    """The program as it is passes; the reference in bfloat16 in its
    place, judged by the same limits, fails at least one of them."""
    bench = small_bench(tmp_path)
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
    (its ``no_tf32`` made a no-op, both flags on) is not correct. The
    readings are printed, for the limits' record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    from event_utils_tpu_torch.models import eraft
    monkeypatch.setattr(eraft, "no_tf32", contextlib.nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    bench = cell_bench()
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    print("tf32", json.dumps(res.readings))
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
    assert np.isfinite(res.readings["flow_max_abs_diff"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FAULTS)
def test_faults_fail_at_the_cells_size(tmp_path, monkeypatch, kind):
    """On the card, at the cell's own size: each planted fault, the
    bfloat16 grid among them, fails at least one limit. The readings are
    printed, for the limits' record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    plant(monkeypatch, kind)
    bench = cell_bench()
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    print(kind, json.dumps(res.readings))
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
