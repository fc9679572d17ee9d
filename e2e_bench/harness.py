"""The benchmark's general parts: finding a cell's files by name, the
measured window, host spans, the profiler slice and the result line.

Everything that belongs to one cell, one configuration or one metric lives
in a file of its own and is found by the name ``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the cell's configuration, driver and traffic;
- ``configs/<config>.json``: the configuration's sizes and precision;
- ``drivers/<driver>.py``: the loop a kind of traffic runs (``Driver``);
- ``references/<config>.py``: the configuration's plain reference;
- ``metrics/<metric>.py``: one reader a metric (``read(run)``).

The busy and idle arithmetic follows ``device_busy`` in ``chip_smoke.py``
and ``scripts/profile_torch_main_path.py`` (device kernels, copies and
memsets under ``torch.profiler``), read over a slice of the measured window
and with the union of the device's intervals in place of their sum.

This module imports neither torch nor the program: ``run.py`` does.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "event_utils_tpu")
NAME_CHARS = 120          # a device operation's name in the breakdown


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file by path under a private module name (file names hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(
        "e2e_bench_" + "".join(c if c.isalnum() else "_" for c in name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the benchmark's folder, looked up by name."""

    def __init__(self, spec_path: str, bench_dir: str = BENCH_DIR):
        self.spec = load_json(spec_path)
        self.dir = bench_dir

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "workloads", name + ".json"))

    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "configs", name + ".json"))

    def driver(self, name: str):
        return load_module(os.path.join(self.dir, "drivers", name + ".py"),
                           "driver_" + name)

    def reference(self, config: str):
        return load_module(os.path.join(self.dir, "references",
                                        config + ".py"), "ref_" + config)

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.dir, "metrics", name + ".py"),
                           "metric_" + name)

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The cell's metrics of ``kind`` ('end_to_end' or 'per_layer'): a
        metric's ``workloads`` list names its cells; an end-to-end metric
        without it holds for every cell. A per-layer metric has to name
        its cells."""
        out = []
        for m in self.spec[kind]:
            if "workloads" not in m and kind == "per_layer":
                raise KeyError(f"per-layer metric {m['name']!r} lists no "
                               "workloads")
            if cell in m.get("workloads", [cell]):
                out.append(m)
        return out


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Spans:
    """Host spans around the calls into each layer, summed per step.
    ``profile=True`` also marks each span in a running ``torch.profiler``
    trace, so that idle gaps can be named by what the host was doing."""

    def __init__(self, enabled: bool = False, profile: bool = False):
        self.enabled = enabled
        self.profile = profile
        self.current: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        mark = contextlib.nullcontext()
        if self.profile:
            import torch
            mark = torch.profiler.record_function("span:" + name)
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.current[name] = (self.current.get(name, 0.0)
                                      + time.perf_counter() - t0)

    def take(self) -> Dict[str, float]:
        out, self.current = self.current, {}
        return out


def run_window(step, seconds: float) -> list:
    """Call ``step()`` back to back for ``seconds``; returns the records of
    the steps that ended inside the window, each with its ``t0`` and
    ``t1``. No step starts after the window's end; one that ends after it
    is not counted."""
    records = []
    deadline = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        rec = step()
        t1 = time.perf_counter()
        if t1 > deadline:
            break
        rec["t0"], rec["t1"] = t0, t1
        records.append(rec)
    return records


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps in ``[lo, hi]`` that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def breakdown(device_ops, spans, lo: float, hi: float, top: int = 10):
    """The trace's ``breakdown``: device time by operation name, and idle
    time in ``[lo, hi]`` by the innermost host span open at each gap's
    middle ('host' where none is). ``device_ops``: (name, start, end);
    ``spans``: (name, start, end); all in seconds on one clock."""
    per: Dict[str, float] = {}
    for name, s, e in device_ops:
        per[name] = per.get(name, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    ops = [(n[:NAME_CHARS], v) for n, v in ops]
    by_span: Dict[str, float] = {}
    spans = sorted(spans, key=lambda x: x[1])
    for s, e in idle_gaps([(a, b) for _, a, b in device_ops], lo, hi):
        mid = 0.5 * (s + e)
        label, width = "host", float("inf")
        for name, a, b in spans:
            if a > mid:
                break
            if b >= mid and b - a < width:
                label, width = name, b - a
        by_span[label] = by_span.get(label, 0.0) + (e - s)
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[dict],
                breakdown_: Optional[dict] = None) -> str:
    """The last line of standard output; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """Each reading beside its limit: a reading passes at or below it. A
    limit with no reading (the check found nothing to compare) fails."""
    checks = []
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value == value and value <= limit
        checks.append({"name": name, "value": value, "limit": limit,
                       "ok": bool(ok)})
    return checks
