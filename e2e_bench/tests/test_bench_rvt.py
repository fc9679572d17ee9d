"""The ``rvt-gen4.detect-stream`` cell on the CPU at a tiny size: its
operation count against PyTorch's own, a rehearsal of ``execute`` untraced
and traced, a parameter count other than the configured failing set-up,
the bfloat16 control and planted faults that must come out not correct,
and the shared ``ConvLSTM`` unchanged at kernel 3. Card tests run the TF32
control and the faults at the cell's own size.

The tiny size: a 256x256 sensor halved to 128x128 (partitions of 2x2
tokens), ~8 windows of 50 ms with ~4,000 events each, chunks of 3, at the
published widths."""

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

CELL = "rvt-gen4.detect-stream"
CONFIG = "rvt-gen4"
SEED = 2**31 + 41


def small_bench(tmp_path, **traffic):
    """The cell at the tiny size, every chunk checked, one warm pass."""
    bench = bench_util.tiny_bench(
        tmp_path, [CELL], num_events=32_000,
        traffic=dict({"chunk": 3, "warmup_passes": 1}, **traffic))
    path = os.path.join(bench.dir, "configs", CONFIG + ".json")
    cfg = harness.load_json(path)
    cfg["sensor"] = [256, 256]
    cfg["padded"] = [128, 128]
    cfg["scene"].update(points=200, draws_per_s=100_000)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return bench


def cell_bench():
    return harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("hw", [(384, 640), (128, 192)])
def test_flops_match_pytorchs_count_of_the_reference(hw):
    bench = cell_bench()
    ref = bench.reference(CONFIG)
    cfg = dict(bench.config(CONFIG), padded=list(hw))
    net = cfg["network"]
    if hw == (384, 640):
        assert ref.flops_per_window(cfg) == cfg["flops_per_window"] \
            == 31_259_197_440
    params = {k: v.to("meta") for k, v in ref.init_params(net, 0).items()}
    x = torch.zeros(1, net["input_channels"], *hw, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(params, x, None, net)
    assert counter.get_total_flops() == ref.flops_per_window(cfg)


def test_the_configuration_is_rvt_b_on_gen4():
    bench = cell_bench()
    cfg = bench.config(CONFIG)
    ref = bench.reference(CONFIG)
    net = cfg["network"]
    assert ref.num_parameters(net) == cfg["parameters"] == 18_536_856
    assert abs(cfg["parameters"] / 18.5e6 - 1) < 0.02
    assert cfg["sensor"] == [720, 1280] and cfg["padded"] == [384, 640]
    assert ref.partition_size(net, *cfg["padded"]) == (6, 10)
    assert net["input_channels"] == 2 * net["num_bins"] == 20
    assert net["anchors"] == sum(384 // s * (640 // s)
                                 for s in net["head_strides"]) == 5040


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tmp_path, trace):
    """``execute`` on the CPU: correct, the end-to-end metrics untraced,
    the program's spans and counters read when traced and the registry
    left as it was."""
    from event_utils_tpu_torch.utils import profiling
    was = profiling.spans_enabled()
    bench = small_bench(tmp_path)
    with host_profiler():
        res = run_mod.execute(bench, CELL, SEED, 10.0, trace, device="cpu")
    assert res.correct, res.readings
    assert res.readings["chunks_checked"] >= 3
    assert profiling.spans_enabled() is was
    assert profiling.take().counts == {}
    if not trace:
        assert set(res.metrics) == {"events_per_s", "setup_s"}
        return
    assert {"fetch_ms.rvt", "forward_ms.rvt",
            "rvt_mfu.rvt"} <= set(res.metrics), res.metrics


def test_each_pass_starts_cold_and_every_span_is_taken(tmp_path):
    """Windows come in chunks of 3 with a pass's rest last; the state is
    reset once a pass; every window runs each of RVT's spans."""
    bench = small_bench(tmp_path)
    ctx = run_mod.make_context(bench, CELL, SEED, "cpu", str(tmp_path),
                               harness.Spans(enabled=True))
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    drv.setup()
    n = drv.n
    recs = [drv.step() for _ in range(2 * (-(-n // 3)))]
    drv.close()
    sizes = [min(3, n - lo) for lo in range(0, n, 3)]
    assert [r["windows"] for r in recs] == sizes * 2
    counts = [r["program"]["counts"] for r in recs]
    assert [c["rvt.windows"] for c in counts] == sizes * 2
    assert sum(c.get("rvt.resets", 0) for c in counts) == 2
    assert all(c["reconstruct.batched_windows"] == r["windows"]
               for c, r in zip(counts, recs))
    spans = recs[0]["program"]["spans"]
    assert {"rvt.attn", "rvt.mlp", "rvt.lstm", "rvt.neck", "rvt.head",
            "reconstruct.fetch"} <= set(spans)
    assert sum(r["events"] for r in recs[:len(sizes)]) == sum(
        b - a for a, b in drv.bounds)


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
    sizes = [min(3, drv.n - lo) for lo in range(0, drv.n, 3)]
    assert [r["windows"] for r in steps] == sizes * 3
    assert drv.pos == 0


def _grid_as_block(monkeypatch):
    from event_utils_tpu_torch.models import rvt
    monkeypatch.setattr(rvt, "grid_partition", rvt.window_partition)
    monkeypatch.setattr(rvt, "grid_reverse", rvt.window_reverse)


def _state_dropped(monkeypatch):
    from event_utils_tpu_torch.models.rvt import RVT
    real = RVT.forward
    monkeypatch.setattr(RVT, "forward",
                        lambda self, x, state=None: real(self, x, None))


def _window_skipped(monkeypatch):
    """Each chunk's first window goes through the network but its state
    is dropped: the next window starts from the state before it."""
    from event_utils_tpu_torch.models.rvt import RVT
    real = RVT.detect

    def broken(self, windows, state=None):
        first, raw0, _ = real(self, windows[:1], state)
        if len(windows) == 1:
            return first, raw0, state
        rest, raw, state = real(self, windows[1:], state)
        return (torch.cat([first, rest]), torch.cat([raw0, raw]), state)
    monkeypatch.setattr(RVT, "detect", broken)


def _polarity_swapped(monkeypatch):
    from event_utils_tpu_torch.data_loaders import base_dataset
    real = base_dataset.stacked_histogram_rows

    def broken(*args, bins, **kwargs):
        h = real(*args, bins=bins, **kwargs)
        return torch.cat([h[:, bins:], h[:, :bins]], 1)
    monkeypatch.setattr(base_dataset, "stacked_histogram_rows", broken)


def _half_events(monkeypatch):
    from event_utils_tpu_torch.data_loaders.memmap_dataset import \
        MemMapDataset
    real = MemMapDataset.get_events
    monkeypatch.setattr(MemMapDataset, "get_events",
                        lambda self, i0, i1: tuple(
                            a[::2] for a in real(self, i0, i1)))


def plant(monkeypatch, kind):
    """Break the program as ``kind`` says: grid-SA computed as block-SA,
    the state dropped before every window, one window a chunk skipped by
    the state, the histogram's polarity halves swapped, or half of each
    window's events."""
    {"grid_as_block": _grid_as_block, "state_dropped": _state_dropped,
     "window_skipped": _window_skipped,
     "polarity_swapped": _polarity_swapped,
     "half_events": _half_events}[kind](monkeypatch)


FAULTS = ["grid_as_block", "state_dropped", "window_skipped",
          "polarity_swapped", "half_events"]


@pytest.mark.parametrize("kind", FAULTS)
def test_faults_are_not_correct(tmp_path, monkeypatch, kind):
    plant(monkeypatch, kind)
    bench = small_bench(tmp_path)
    res = run_mod.execute(bench, CELL, SEED, 0.5, 0, device="cpu")
    assert not res.correct, res.readings


def test_a_network_other_than_the_configured_fails_setup(tmp_path,
                                                         monkeypatch):
    """The program has to load the reference's weights for the configured
    network, key for key and shape for shape."""
    from event_utils_tpu_torch.models import rvt
    monkeypatch.setattr(rvt, "HEAD_WIDTH", 96)
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


def _conv_lstm_before(gates, x, state):
    """``ConvLSTM.forward`` as it was at kernel 3 alone, written out."""
    import torch.nn.functional as F
    h, c = state
    i, f, o, g = F.conv2d(torch.cat([x, h], 1), gates.weight, gates.bias,
                          1, 1).chunk(4, 1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def test_conv_lstm_at_kernel_3_is_unchanged():
    """``UNetRecurrent``'s ConvLSTM, now with a kernel argument, gives the
    same bits at its default kernel 3 on a seeded input as its body did
    before, under the same keys; and ``UNetRecurrent`` (seed 11) gives,
    warm, the output and deepest cell state it gave before the argument
    came (sums pinned from that code on the CPU, to 1e-6)."""
    from event_utils_tpu_torch.models.networks import (ConvLSTM,
                                                       UNetRecurrent)
    cell = ConvLSTM(16, 24)
    assert cell.Gates.kernel == 3
    assert set(cell.state_dict()) == {"Gates.weight", "Gates.bias"}
    assert cell.Gates.weight.shape == (96, 40, 3, 3)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        x = torch.randn(2, 16, 12, 20, generator=g)
        state = (torch.randn(2, 24, 12, 20, generator=g),
                 torch.randn(2, 24, 12, 20, generator=g))
        got = cell(x, state)
        want = _conv_lstm_before(cell.Gates, x, state)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        zero = cell(x)
        want = _conv_lstm_before(cell.Gates, x,
                                 (torch.zeros_like(state[0]),) * 2)
        assert all(torch.equal(a, b) for a, b in zip(zero, want))
        net = UNetRecurrent(5, 32, 3, 2, seed=11).eval()
        x = torch.randn(1, 5, 32, 48,
                        generator=torch.Generator().manual_seed(5))
        for _ in range(2):
            net(x)
        _, st = net(x)
        img, st = net(x, st)
    assert float(img.double().sum()) == pytest.approx(543.035114421742,
                                                      rel=1e-6)
    assert float(st[2][1].double().sum()) == pytest.approx(
        11.782651606874424, rel=1e-6)


@pytest.mark.cuda
def test_tf32_control_fails_at_the_cells_size(tmp_path, monkeypatch):
    """On the card, at the cell's own size: the program with TF32 allowed
    (its ``no_tf32`` made a no-op, both flags on) is not correct. The
    readings are printed, for the limits' record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    from event_utils_tpu_torch.models import rvt
    monkeypatch.setattr(rvt, "no_tf32", contextlib.nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    bench = cell_bench()
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    print("tf32", json.dumps(res.readings))
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
    assert np.isfinite(res.readings["pred_max_rel_diff"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FAULTS)
def test_faults_fail_at_the_cells_size(tmp_path, monkeypatch, kind):
    """On the card, at the cell's own size: each planted fault fails at
    least one limit. The readings are printed, for the limits' record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    plant(monkeypatch, kind)
    bench = cell_bench()
    res = run_mod.execute(bench, CELL, SEED, 5.0, 0)
    print(kind, json.dumps(res.readings))
    checks = harness.judge(res.readings,
                           bench.workload(CELL)["check"]["limits"])
    assert not all(c["ok"] for c in checks), res.readings
