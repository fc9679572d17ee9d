"""The program's spans and counters (``utils.profiling``) on the CPU: the
off state records nothing and only marks a running profiler, nesting, per-name totals and self times, the
same-name recursion timed once, counters, ``take``, the spans on a running
``torch.profiler``'s clock and in ``trace``'s Chrome trace, and the spans
and the upload counter the ROI solver and the native loader record, with
the solver's outputs bitwise equal with spans on and off."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.data_loaders import NativeWindowedLoader
from event_utils_tpu_torch.ops.blur import gaussian_kernel1d
from event_utils_tpu_torch.utils import profiling

SENSOR = (24, 32)
ROI = (8, 8)          # 3 x 4 = 12 ROIs
MAXITER = 4


@pytest.fixture
def spans_on():
    """Spans on for the test, nothing left over before or after it."""
    was = profiling.enable_spans(True)
    profiling.take()
    yield
    profiling.enable_spans(was)
    profiling.take()


@pytest.fixture
def spans_off():
    was = profiling.enable_spans(False)
    profiling.take()
    yield
    profiling.enable_spans(was)


def names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def scene(seed=0, n=4000, flow=(10.0, 5.0)):
    """Points moving at a planted flow over the small sensor."""
    g = np.random.default_rng(seed)
    H, W = SENSOR
    px, py = g.uniform(2, W - 14, 30), g.uniform(2, H - 8, 30)
    pol = g.choice([-1.0, 1.0], 30)
    idx = g.integers(0, 30, n)
    ts = np.sort(g.uniform(0, 1.0, n))
    xs = px[idx] + flow[0] * ts + g.normal(0, 0.1, n)
    ys = py[idx] + flow[1] * ts + g.normal(0, 0.1, n)
    return tuple(a.astype(np.float32) for a in (xs, ys, ts, pol[idx]))


def test_spans_off_record_nothing(spans_off):
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b                      # one shared no-op
    with a:
        with profiling.span("c"):
            profiling.count("x", 5)

    @profiling.spanned("d")
    def f(v):
        return v + 1

    assert f(1) == 2 and f.__name__ == "f"
    got = profiling.take()
    assert got.spans == [] and got.counts == {}
    assert not profiling.spans_enabled()


def test_nesting_parents_totals_and_self_times(spans_on, monkeypatch):
    clock = iter([0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 7.0, 8.0, 10.0, 13.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    with profiling.span("solve"):                  # 0 .. 13
        with profiling.span("bucket"):             # 1 .. 2
            pass
        with profiling.span("descent"):            # 3 .. 10
            with profiling.span("grad"):           # 4 .. 6
                pass
            with profiling.span("solve"):          # inside a solve: untimed
                with profiling.span("grad"):       # 7 .. 8
                    pass
    monkeypatch.undo()
    got = profiling.take(request=7)
    assert got.request == 7
    assert [s.name for s in got.spans] == ["solve", "bucket", "descent",
                                           "grad", "grad"]
    solve, bucket, descent, g1, g2 = got.spans
    assert solve.parent is None
    assert bucket.parent is solve and descent.parent is solve
    assert g1.parent is descent and g2.parent is descent
    assert (g2.start, g2.end) == (7.0, 8.0)
    assert profiling.totals(got.spans) == {"solve": 13.0, "bucket": 1.0,
                                           "descent": 7.0, "grad": 3.0}
    assert profiling.self_times(got.spans) == {"solve": 5.0, "bucket": 1.0,
                                               "descent": 4.0, "grad": 3.0}


def test_a_span_closed_after_a_take_keeps_its_parent(spans_on):
    with profiling.span("outer") as outer:
        with profiling.span("inner"):
            pass
        first = profiling.take()
    second = profiling.take()
    assert [s.name for s in first.spans] == ["inner"]
    assert first.spans[0].parent is outer
    assert [s.name for s in second.spans] == ["outer"]
    assert profiling.self_times(first.spans) == profiling.totals(first.spans)


def test_counters_add_up_and_take_resets(spans_on):
    profiling.count("a")
    profiling.count("a", 4)
    profiling.count("b", 2)
    assert profiling.take().counts == {"a": 5, "b": 2}
    got = profiling.take()
    assert got.counts == {} and got.spans == []


def test_threads_count_every_add_and_keep_their_own_stacks(spans_on):
    n_threads, adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with profiling.span("worker"):
                for _ in range(adds):
                    profiling.count("n", 1)

        with profiling.span("main"):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.take()
    assert got.counts == {"n": n_threads * adds}
    workers = [s for s in got.spans if s.name == "worker"]
    assert len(workers) == n_threads
    assert all(s.parent is None for s in workers)


def test_spans_sit_inside_their_parents_on_the_profilers_clock(spans_on):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
            torch.ones(8).sum()
    ev = {e.name: e.time_range for e in prof.events()
          if e.name.startswith("span:")}
    assert set(ev) == {"span:outer", "span:inner"}
    out, inn = ev["span:outer"], ev["span:inner"]
    assert out.start <= inn.start and inn.end <= out.end
    assert names(profiling.take().spans) == {"outer": 1, "inner": 1}
    # no profiler running: the span opens no profiler event
    with profiling.span("quiet") as s:
        pass
    assert s._mark is None and profiling.take().spans[0].name == "quiet"


def test_spans_off_still_mark_a_running_profiler(spans_off):
    """Off, a span keeps nothing for ``take`` but still names its block in
    a running profile, so a profiler's trace names the program's layers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
            profiling.count("x", 3)
    ev = {e.name: e.time_range for e in prof.events()
          if e.name.startswith("span:")}
    assert set(ev) == {"span:outer", "span:inner"}
    out, inn = ev["span:outer"], ev["span:inner"]
    assert out.start <= inn.start and inn.end <= out.end
    got = profiling.take()
    assert got.spans == [] and got.counts == {}
    assert profiling.span("after") is profiling.span("again")


@pytest.mark.parametrize("before", [False, True])
def test_trace_turns_spans_on_and_restores_them(tmp_path, before):
    was = profiling.enable_spans(before)
    profiling.take()
    try:
        with profiling.trace(str(tmp_path / "tr")) as path:
            assert profiling.spans_enabled()
            with profiling.span("traced"):
                torch.ones(32, 32).matmul(torch.ones(32, 32)).sum()
        assert profiling.spans_enabled() is before
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "span:traced" for e in events)
        assert names(profiling.take().spans) == {"traced": 1}
    finally:
        profiling.enable_spans(was)
        profiling.take()


def solve(x0=None, solver="gd"):
    xs, ys, ts, ps = scene()
    return pc.grid_cmax_batched(xs, ys, ts, ps, roi_size=ROI,
                                img_size=SENSOR, maxiter=MAXITER, x0=x0,
                                solver=solver, device="cpu")


def packed_bytes():
    """Bytes of the bucketed batches and origins the solver uploads."""
    was = profiling.enable_spans(False)
    try:
        out = pc.bucket_events_by_roi(*scene(), SENSOR, ROI, device="cpu")
    finally:
        profiling.enable_spans(was)
    return sum(t.nbytes for t in out[:6])


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_roi_solve_same_with_spans_and_records_its_layers(warm):
    rng = np.random.default_rng(1)
    R = (SENSOR[0] // ROI[0]) * (SENSOR[1] // ROI[1])
    x0 = (rng.normal(0, 3, (R, 2)) + [10.0, 5.0]).astype(np.float32)
    x0 = x0 if warm else None
    was = profiling.enable_spans(False)
    profiling.take()
    try:
        off = solve(x0)
        assert profiling.take().spans == []
        profiling.enable_spans(True)
        on = solve(x0)
        got = profiling.take()
    finally:
        profiling.enable_spans(was)
        profiling.take()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = {"cmax.solve": 1, "cmax.bucket": 1, "cmax.descent": 1,
            "cmax.grad": MAXITER}
    if not warm:
        want["cmax.grid_search"] = 1
    assert names(got.spans) == want
    by = {s.name: s for s in got.spans}
    assert by["cmax.bucket"].parent is by["cmax.solve"]
    assert by["cmax.descent"].parent is by["cmax.solve"]
    assert all(s.parent is by["cmax.descent"] for s in got.spans
               if s.name == "cmax.grad")
    # the uploads: batches and origins, the warm start, the ROI size row,
    # the blur taps once a solve (the solve's loss keeps them on the device
    # for every evaluation after its first), and the cold grid search's
    # sample scale and sample indices
    taps = gaussian_kernel1d(1.0).size * 4
    want_bytes = packed_bytes() + 2 * 8
    if warm:
        want_bytes += x0.nbytes
    else:
        n_scale = pc._sample_scale(5, False).size
        want_bytes += n_scale * 4 + (2 * n_scale + 1) ** 2 * 2 * 8
    assert got.counts == {pc.H2D_BYTES: want_bytes + taps}


def test_bfgs_refine_records_descent_and_grads(spans_on):
    R = (SENSOR[0] // ROI[0]) * (SENSOR[1] // ROI[1])
    solve(np.tile(np.float32([10.0, 5.0]), (R, 1)), solver="bfgs")
    got = profiling.take()
    n = names(got.spans)
    assert n["cmax.solve"] == 1 and n["cmax.descent"] == 1
    assert n["cmax.grad"] >= 1
    descent = next(s for s in got.spans if s.name == "cmax.descent")
    assert all(s.parent is descent for s in got.spans
               if s.name == "cmax.grad")


def test_native_loader_records_one_fill_per_batch(tmp_path, spans_on):
    g = np.random.default_rng(3)
    n = 5000
    mm = tmp_path / "mm"
    mm.mkdir()
    np.save(mm / "t.npy", np.sort(g.uniform(0, 1.0, n))[:, None])
    np.save(mm / "xy.npy", g.integers(0, 32, (n, 2)).astype(np.int16))
    np.save(mm / "p.npy", g.integers(0, 2, n).astype(np.uint8)[:, None])
    loader = NativeWindowedLoader(str(mm), method="k_events", k=700,
                                  batch_size=2)
    try:
        batches = sum(1 for _ in loader)
    finally:
        loader.close()
    got = profiling.take()
    assert batches == len(loader) == 4
    assert names(got.spans) == {"loader.fill": batches}
