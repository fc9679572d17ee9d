"""The busy, idle and breakdown arithmetic on synthetic intervals, the
import check by whole top-level names, and the shape of the last line."""

import json

import bench_util  # noqa: F401
import harness


def test_union_of_intervals():
    assert harness.union_length([]) == 0.0
    assert harness.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert harness.union_length([(3, 4), (0, 1), (1, 2)]) == 3.0
    assert harness.union_length([(0, 10), (2, 3), (4, 5)]) == 10.0


def test_idle_gaps_and_breakdown():
    ops = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 5.5)]
    assert harness.idle_gaps([(s, e) for _, s, e in ops], 0.0, 6.0) == [
        (0.0, 1.0), (3.0, 5.0), (5.5, 6.0)]
    spans = [("solve", 0.0, 4.0), ("window_fetch", 4.0, 6.0),
             ("inner", 3.5, 4.5)]
    b = harness.breakdown(ops, spans, 0.0, 6.0)
    assert b["device_ops"] == [["k1", 1.5], ["k2", 1.5]]
    # gaps: [0,1] mid 0.5 -> solve; [3,5] mid 4 -> inner (innermost);
    # [5.5,6] mid 5.75 -> window_fetch
    assert dict((n, v) for n, v in b["idle_gaps"]) == {
        "solve": 1.0, "inner": 2.0, "window_fetch": 0.5}
    busy = harness.union_length([(s, e) for _, s, e in ops])
    assert busy == 2.5


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["event_utils_tpu_torch", "event_utils_tpu_torch.ops", "jaxtyping",
             "jaxlib_like", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["event_utils_tpu.ops"]) == [
        "event_utils_tpu.ops"]
    assert harness.forbidden_modules(["jax.numpy", "flax", "jaxlib.xla"]) == [
        "flax", "jax.numpy", "jaxlib.xla"]


def test_last_line_shape():
    checks = harness.judge({"a": 1e-6, "b": 3.0}, {"a": 1e-3, "b": 2.0,
                                                   "c": 1.0})
    assert [c["ok"] for c in checks] == [True, False, False]
    line = harness.result_line(
        False, 10, 0, {"events_per_s": {"value": 1.5, "unit": "events/s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 5}, checks,
        {"device_ops": [["k", 0.1]], "idle_gaps": [["solve", 0.2]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"]["b"] == {"value": 3.0, "limit": 2.0}
    assert out["checks"]["c"] == {"value": None, "limit": 1.0}
