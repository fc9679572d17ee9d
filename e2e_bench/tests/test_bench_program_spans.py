"""The program's own spans (``utils.profiling``) in a CPU rehearsal of the
roi-stream cell: a traced run leaves them off but finds their
``span:<name>`` marks on the profiler's clock, where the breakdown names
the idle gaps by them; an untraced run opens neither."""

import pytest
import torch

import bench_util
import run as run_mod
from event_utils_tpu_torch.contrast_max import events_cmax
from event_utils_tpu_torch.utils import profiling

CELL = "cmax-davis240.roi-stream"
PROGRAM = {"cmax.solve", "cmax.bucket", "cmax.descent", "cmax.grad",
           "loader.fill"}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_marks_the_programs_spans_when_traced(tmp_path,
                                                        monkeypatch, trace):
    """``execute`` on the CPU at a tiny size, the profiler on the host
    alone and ``torch.cuda.synchronize`` stubbed, as the other rehearsals
    patch what they need."""
    from torch.profiler import ProfilerActivity
    real_profile = torch.profiler.profile
    monkeypatch.setattr(
        torch.profiler, "profile",
        lambda *a, activities=None, **kw: real_profile(
            *a, activities=[ProfilerActivity.CPU], **kw))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = []
    real_solve = events_cmax.grid_cmax_batched

    def solve(*a, **kw):
        seen.append(profiling.spans_enabled())
        return real_solve(*a, **kw)

    monkeypatch.setattr(events_cmax, "grid_cmax_batched", solve)
    traced_spans = []
    real_trace = run_mod.device_trace

    def device_trace(prof):
        out = real_trace(prof)
        traced_spans.extend(out[1])
        return out

    monkeypatch.setattr(run_mod, "device_trace", device_trace)
    was = profiling.spans_enabled()
    profiling.take()
    bench = bench_util.tiny_bench(tmp_path, [CELL],
                                  traffic={"maxiter": 2, "k": 5000})
    res = run_mod.execute(bench, CELL, 2**31 + 17, 1.0, trace,
                          device="cpu")
    assert res.correct, res.readings
    assert seen and not any(seen)
    assert profiling.spans_enabled() is was
    got = profiling.take()
    assert got.spans == [] and got.counts == {}
    names = {n for n, _, _ in traced_spans}
    if not trace:
        assert res.profile is None and not names
        return
    # the driver's spans and the program's, on the profiler's clock
    assert {"solve", "window_fetch"} | PROGRAM <= names, names
    assert "solve_ms.cmax" in res.metrics
