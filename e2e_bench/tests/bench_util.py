"""Helpers of the benchmark's CPU tests: the benchmark's folder on the path
and a copy of it, cut to tiny sizes, in a temporary directory."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_bench(tmp, cells, num_events=60_000, fraction=1.0,
               traffic=None):
    """A copy of the benchmark in ``tmp`` whose ``cells`` take recordings
    of ``num_events`` events, one warm-up step, keep every window for the
    check, and take ``traffic`` overrides. Returns a ``harness.Bench``."""
    import harness

    dst = os.path.join(str(tmp), "e2e_bench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for name in cells:
        path = os.path.join(dst, "workloads", name + ".json")
        wl = harness.load_json(path)
        wl["check"]["fraction"] = fraction
        t = wl["traffic"]
        t.update(traffic or {})
        t["warmup_windows"] = 1
        cfg_path = os.path.join(dst, "configs", wl["config"] + ".json")
        cfg = harness.load_json(cfg_path)
        cfg["num_events"] = num_events
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        with open(path, "w") as f:
            json.dump(wl, f)
    spec_path = os.path.join(str(tmp), "BENCHMARK.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return harness.Bench(spec_path, dst)
