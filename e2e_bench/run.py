"""Run one cell of the benchmark once and print its result line.

    python3 e2e_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cell's files are found by name
(``harness.Bench``), its driver sets up (recording, program, warm-up: the
set-up time runs from the start of this process to the end of it), then
steps for ``--seconds`` (the measured window), then its answers are checked
against the configuration's plain reference. With ``--trace 0`` the result
line carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from host spans, the program's launch counters and a
``torch.profiler`` slice in the middle of the window. The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit. Exits 3 without a result when
there is no card (or too few), and 4 when the process loaded JAX or the JAX
package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Kernel caches at fixed paths inside the checkout (the program's nvcc
# build keys itself under event_utils_tpu_torch/_build/).
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".e2e_cache", "triton")
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

TRACE_SLICE_S = 2.0       # seconds of the window under torch.profiler
PACE_S = 5.0              # windows completed are also printed a 5 s slice


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_context(bench, name, seed, device, workdir, spans):
    cell = bench.cell(name)
    wl = bench.workload(name)
    cfg = bench.config(cell["config"])
    return types.SimpleNamespace(
        name=name, seed=seed, cell=cell, wl=wl, cfg=cfg, device=device,
        workdir=workdir, spans=spans, bench=bench)


def launch_snapshot():
    from event_utils_tpu_torch.ops import cuda_scatter
    return cuda_scatter.launch_counts()


def device_trace(prof):
    """``(device_ops, host_spans, window)`` from a finished profile, in
    seconds on the profiler's clock: device kernels, copies and memsets as
    (name, start, end); the benchmark's spans likewise; and the window's
    (start, end)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, window = [], [], None
    for e in prof.events():
        s = e.time_range.start * 1e-6
        t = e.time_range.end * 1e-6
        if e.name.startswith("span:"):
            if e.device_type != cuda:
                spans.append((e.name[5:], s, t))
        elif e.name == "e2e_window":
            if e.device_type != cuda:
                window = (s, t)
        elif e.device_type == cuda:
            ops.append((e.name, s, t))
    return ops, spans, window


def measure(drv, seconds, trace):
    """The measured window. Returns ``(records, seconds_of_records,
    all_records, profile)``: with tracing, a ``TRACE_SLICE_S`` slice in the
    middle of the window runs under the profiler, and the spans and
    counters are read over the rest."""
    import torch

    def step():
        rec = drv.step()
        if trace:
            counts = launch_snapshot()
            rec["launches"] = {k: v - step.last.get(k, 0)
                               for k, v in counts.items()}
            step.last = counts
            rec["spans"] = drv.ctx.spans.take()
        return rec

    step.last = launch_snapshot() if trace else {}
    if not trace:
        records = harness.run_window(step, seconds)
        return records, seconds, records, None
    from torch.profiler import ProfilerActivity, profile, record_function
    slice_s = min(TRACE_SLICE_S, seconds / 2.0)
    lead_s = (seconds - slice_s) / 2.0
    drv.ctx.spans.enabled = True
    before = harness.run_window(step, lead_s)
    drv.ctx.spans.profile = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("e2e_window"):
            traced = harness.run_window(step, slice_s)
            torch.cuda.synchronize()
    drv.ctx.spans.profile = False
    drv.ctx.spans.take()
    step.last = launch_snapshot()
    after = harness.run_window(step, seconds - slice_s - lead_s)
    ops, spans, window = device_trace(prof)
    if window is None:
        raise RuntimeError("the profile holds no window span")
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
              if e > lo and s < hi]
    busy = harness.union_length([(s, e) for _, s, e in inside])
    profile_ = {"busy_s": busy, "window_s": hi - lo,
                "breakdown": harness.breakdown(inside, spans, lo, hi)}
    return (before + after, seconds - slice_s, before + traced + after,
            profile_)


def execute(bench, name, seed, seconds, trace, device="cuda"):
    """Set up, measure and check one run of the cell ``name``; returns the
    result's parts. ``device='cpu'`` drives the same run on the host (the
    tests' rehearsal): nothing of it is a device number."""
    import torch
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spans = harness.Spans()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as work:
        ctx = make_context(bench, name, seed, device, work, spans)
        drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
        drv.setup()
        sync()
        setup_s = time.perf_counter() - T_START
        records, rec_s, all_records, prof = measure(drv, seconds, trace)
        sync()
        peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        run = types.SimpleNamespace(records=records, seconds=rec_s,
                                    setup_s=setup_s, profile=prof, ctx=ctx,
                                    bench=bench)
        metrics = {}
        for m in bench.metrics(name, "per_layer" if trace else "end_to_end"):
            value = bench.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        drv.close()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        readings = drv.check(torch.float32)
        t_check = time.perf_counter() - t_check
        checks = harness.judge(readings, ctx.wl["check"]["limits"])
    start = min((r["t0"] for r in all_records), default=0.0)
    end = max((r["t1"] for r in all_records), default=start)
    pace = [0] * (int((end - start) // PACE_S) + 1)
    for r in all_records:
        pace[int((r["t1"] - start) // PACE_S)] += r["windows"]
    return types.SimpleNamespace(
        correct=all(c["ok"] for c in checks), checks=checks, pace=pace,
        readings=readings, metrics=metrics, peak=peak, profile=prof,
        attempted=sum(r["windows"] for r in all_records), setup_s=setup_s,
        setup_parts=drv.setup_parts, check_s=t_check)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
    cell = bench.cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"no card: this cell needs {cell['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = execute(bench, args.workload, args.seed, args.seconds, args.trace)
    found = harness.forbidden_modules()
    if found:
        print("loaded JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(res.peak)}
    if res.profile is not None:
        device["busy_s"] = res.profile["busy_s"]
        device["window_s"] = res.profile["window_s"]
    print(f"timing: setup {res.setup_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in res.setup_parts.items())
          + f"), window {args.seconds} s, check {res.check_s:.3f} s",
          file=sys.stderr)
    print(f"windows a {PACE_S:g} s slice: {res.pace}", file=sys.stderr)
    for c in res.checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(
        res.correct, res.attempted, 0, res.metrics, device, res.checks,
        res.profile["breakdown"] if res.profile else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
