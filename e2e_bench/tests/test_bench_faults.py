"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference computed in bfloat16 in the program's
place): each cell's run is driven on the CPU at a tiny size with the
committed limits, the look for a card skipped."""

import os
import tempfile

import pytest
import torch

import bench_util  # noqa: F401
import calibrate
import harness
import run as run_mod

SEED = 2**31 + 17


def _roi_fault(kind, real):
    def broken(xs, ys, ts, ps, **kw):
        if kind == "state_unchanged" and kw.get("x0") is not None:
            kw["maxiter"] = 0           # the descent returns its start
        if kind == "half_batch":
            xs, ys, ts, ps = (a[::2] for a in (xs, ys, ts, ps))
        params, rois, f, valid = real(xs, ys, ts, ps, **kw)
        if kind == "answer_altered":
            params = params + 1.0      # 1 px/s on every ROI
        return params, rois, f, valid
    return broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_roi_stream_faults_are_not_correct(tmp_path, monkeypatch, kind):
    from event_utils_tpu_torch.contrast_max import events_cmax
    monkeypatch.setattr(events_cmax, "grid_cmax_batched",
                        _roi_fault(kind, events_cmax.grid_cmax_batched))
    bench = bench_util.tiny_bench(tmp_path, ["cmax-davis240.roi-stream"])
    res = run_mod.execute(bench, "cmax-davis240.roi-stream", SEED, 1.0, 0,
                          device="cpu")
    assert not res.correct, res.readings


def _loader_fault(kind, real):
    def broken(self):
        for i, batch in enumerate(real(self)):
            if kind == "window_skipped" and i == 1:
                continue
            yield batch
            if i == 1 and kind == "window_repeated":
                yield batch
            if i == 1 and kind == "window_repeated_relabelled":
                yield dict(batch, window_idx0=batch["window_idx1"],
                           window_idx1=2 * batch["window_idx1"]
                           - batch["window_idx0"])
    return broken


@pytest.mark.parametrize("kind", ["window_skipped", "window_repeated",
                                  "window_repeated_relabelled"])
def test_roi_stream_loader_faults_are_not_correct(tmp_path, monkeypatch,
                                                  kind):
    """A loader that skips a window or hands one over twice (with its own
    indices, or relabelled as the next) is caught against the bounds the
    driver works out itself."""
    from event_utils_tpu_torch.data_loaders import native_loader
    monkeypatch.setattr(native_loader.NativeWindowedLoader, "__iter__",
                        _loader_fault(kind, native_loader
                                      .NativeWindowedLoader.__iter__))
    bench = bench_util.tiny_bench(tmp_path, ["cmax-davis240.roi-stream"],
                                  traffic={"maxiter": 2})
    res = run_mod.execute(bench, "cmax-davis240.roi-stream", SEED, 1.0, 0,
                          device="cpu")
    assert not res.correct, res.readings


@pytest.mark.parametrize("cell", ["cmax-davis240.roi-stream"])
def test_sound_runs_and_the_control(tmp_path, cell):
    """The program as it is passes; the control, judged by the same limits,
    fails at least one of them."""
    bench = bench_util.tiny_bench(tmp_path, [cell], num_events=200_000)
    res = run_mod.execute(bench, cell, SEED, 1.0, 0, device="cpu")
    assert res.correct, res.readings
    ctx = run_mod.make_context(bench, cell, SEED, "cpu", str(tmp_path),
                               harness.Spans())
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    drv.setup()
    drv.close()
    control = drv.check(torch.float32, control=torch.bfloat16)
    checks = harness.judge(control, ctx.wl["check"]["limits"])
    assert not all(c["ok"] for c in checks), control


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """On the card, at the cell's own size: the control fails on three
    seeds (``calibrate.py`` gives the same readings over more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    for cell in [w["name"] for w in bench.spec["workloads"]]:
        limits = bench.workload(cell)["check"]["limits"]
        for seed in (11, 12, 13):
            with tempfile.TemporaryDirectory() as work:
                out = calibrate.readings_for(bench, cell, seed, 3.0, 0.3,
                                             True, "cuda", work)
            checks = harness.judge(out["control"], limits)
            assert not all(c["ok"] for c in checks), (cell, seed, out)
            assert all(c["ok"] for c in harness.judge(out["program"],
                                                      limits)), (cell, out)

