"""The benchmark finds every piece by name, and a new cell, configuration
and per-layer metric are new files plus new entries: nothing there is
edited."""

import json
import os

import bench_util  # noqa: F401  (puts the benchmark on the path)
import harness
import run as run_mod


def spec():
    return harness.load_json(os.path.join(bench_util.ROOT, "BENCHMARK.json"))


def test_every_entry_has_its_files():
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    s = spec()
    for c in s["configs"]:
        assert os.path.exists(os.path.join(bench_util.ROOT, c["file"]))
        assert bench.config(c["name"])["name"] == c["name"]
        bench.reference(c["name"])
    for w in s["workloads"]:
        wl = bench.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert hasattr(bench.driver(wl["driver"]), "Driver")
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics(w["name"], kind):
                assert callable(bench.metric_reader(m["name"]).read)
    names = {m["name"] for k in ("end_to_end", "per_layer") for m in s[k]}
    assert "setup_s" in names


def test_every_cell_reports_what_its_per_layer_metrics_move():
    bench = harness.Bench(os.path.join(bench_util.ROOT, "BENCHMARK.json"))
    for w in spec()["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = bench.metrics(w["name"], "per_layer")
        assert per
        assert all(m["moves"] in e2e for m in per)


def test_a_new_cell_config_and_metric_are_new_files(tmp_path):
    bench = bench_util.tiny_bench(tmp_path, [])
    d = bench.dir
    cfg = dict(bench.config("cmax-davis240"), name="dummy-cfg",
               num_events=30_000)
    with open(os.path.join(d, "configs", "dummy-cfg.json"), "w") as f:
        json.dump(cfg, f)
    wl = dict(bench.workload("cmax-davis240.roi-stream"), config="dummy-cfg")
    wl["traffic"] = dict(wl["traffic"], k=10_000, maxiter=2,
                         warmup_windows=1)
    with open(os.path.join(d, "workloads", "dummy.cell.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(d, "metrics", "windows_done.dummy.py"), "w") as f:
        f.write("def read(run):\n"
                "    return float(sum(r['windows'] for r in run.records))\n")
    # the reference is found by the configuration's name
    os.symlink(os.path.join(d, "references", "cmax-davis240.py"),
               os.path.join(d, "references", "dummy-cfg.py"))
    s = harness.load_json(os.path.join(str(tmp_path), "BENCHMARK.json"))
    s["configs"].append({"name": "dummy-cfg", "source": "x",
                         "file": "e2e_bench/configs/dummy-cfg.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "dummy.cell", "config": "dummy-cfg",
                           "traffic": "dummy", "chips": 1, "why": "x"})
    for m in s["end_to_end"]:
        if m["name"] == "events_per_s":
            m["workloads"].append("dummy.cell")
    s["per_layer"].append({"name": "windows_done.dummy", "unit": "windows",
                           "better": "higher", "source": "program_counter",
                           "layer": "drivers", "moves": "events_per_s",
                           "workloads": ["dummy.cell"]})
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(s, f)
    bench = harness.Bench(path, d)
    names = [m["name"] for m in bench.metrics("dummy.cell", "per_layer")]
    assert names == ["windows_done.dummy"]
    res = run_mod.execute(bench, "dummy.cell", 7, 0.5, 0, device="cpu")
    assert set(res.metrics) == {"events_per_s", "setup_s"}
    assert res.correct


def _imports(path):
    import ast
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_neither_jax_nor_the_old_benchmark():
    banned = {"jax", "jaxlib", "flax", "event_utils_tpu", "chip_smoke",
              "bench", "benchmarks", "scripts"}
    for dirpath, _, files in os.walk(bench_util.BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & banned, (path, tops & banned)
            if os.path.basename(dirpath) == "references":
                assert "event_utils_tpu_torch" not in tops, path
