"""Readings of a cell's correctness check for the program and for its
control, over many seeds in one process: the numbers its limits are set
from.

    python3 e2e_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 5 [--fraction 0.2] [--out file.json]

For each seed the cell's driver sets up as in a run, steps for
``--seconds`` (a short window at the cell's own load), and its kept answers
are checked: once as the program gave them, and, for the control seeds,
once more with the answers replaced by the configuration's reference
computed in bfloat16 (the control, which has to come out not correct).
``--fraction`` raises the share of windows kept, so that a short window
checks as many as a run does. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".e2e_cache", "triton")
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import run as run_mod  # noqa: E402


def readings_for(bench, name, seed, seconds, fraction, control, device,
                 workdir):
    import torch
    ctx = run_mod.make_context(bench, name, seed, device, workdir,
                               harness.Spans())
    if fraction is not None:
        ctx.wl["check"]["fraction"] = fraction
    drv = bench.driver(ctx.wl["driver"]).Driver(ctx)
    t0 = time.perf_counter()
    drv.setup()
    records = harness.run_window(drv.step, seconds)
    drv.close()
    out = {"seed": seed, "windows": sum(r["windows"] for r in records),
           "setup_and_window_s": time.perf_counter() - t0}
    t1 = time.perf_counter()
    out["program"] = drv.check(torch.float32)
    out["check_s"] = time.perf_counter() - t1
    if control:
        out["control"] = drv.check(torch.float32, control=torch.bfloat16)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fraction", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    results = []
    for seed in sorted(set(seeds) | controls):
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as w:
            res = readings_for(bench, args.workload, seed, args.seconds,
                               args.fraction, seed in controls, args.device,
                               w)
        print(json.dumps(res), flush=True)
        results.append(res)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for side in ("program", "control"):
        rows = [r[side] for r in results if side in r]
        if rows:
            summary[side] = {k: [min(r[k] for r in rows),
                                 max(r[k] for r in rows)] for k in rows[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "results": results,
                       "summary": summary}, f, indent=1)
    found = harness.forbidden_modules()
    if found:
        print("loaded JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
