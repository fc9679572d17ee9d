"""The port's ``stream_flow`` CLI against the JAX package's, on the CPU.

One 32x32 recording of a texture translating at a uniform (25, 12) px/s
(the scene of JAX's ``tests/test_cli.py::test_stream_flow_cli``), written
by the port's simulator as HDF5 and as a memmap directory, streams through
both CLIs at k = 6000, 16x16 ROIs, ``--pyramid_first``. File names,
shapes and ``timestamps.txt`` must be equal.

Each window's solve is held against JAX's from the same warm start: the
fixed-step ROI descents of the two packages part by up to ~1.5 px/s per
ROI on the last bits of the patch loss (``ROADMAP.md`` queue 3, "Per-ROI
parity"), and a warm-started stream carries that difference into the next
window's start. So JAX's CLI runs with each window's ``x0`` replaced by the
port's, and each window's dense-field median must lie within 0.5 px/s of
JAX's, per component, the rule of ``tests/test_torch_roi_solvers.py``; a
free-running JAX stream is held to the ground truth as JAX's own test holds
it (10 px/s).
"""

import json
import os

import numpy as np
import pytest
import torch

from event_utils_tpu.cli import stream_flow as j_stream
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu_torch.cli import simulate
from event_utils_tpu_torch.cli import stream_flow
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.errors import DeviceUnavailableError
from event_utils_tpu_torch.utils import profiling

GT = (25.0, 12.0)
MED_ATOL = 0.5
SIM = ["--device", "cpu", "--sensor", "32", "32", "--velocity", "25", "12",
       "--duration", "0.8", "--fps", "120", "--frame_fps", "20", "--c_pos",
       "0.12", "--c_neg", "0.12", "--octaves", "3", "--seed", "3"]
ARGS = ["--k", "6000", "--maxiter", "20", "--roi_size", "16", "16",
        "--pyramid_first"]


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    h5, mm = str(d / "s.h5"), str(d / "smm")
    simulate.main([h5] + SIM)
    simulate.main([mm] + SIM)
    return h5, mm


def medians(out):
    n = len([f for f in os.listdir(out) if f.endswith(".npy")])
    return np.stack([np.median(np.load(os.path.join(
        out, f"flow_{i:04d}.npy")).reshape(2, -1), axis=1) for i in range(n)])


@pytest.fixture(scope="module")
def port_run(recs, tmp_path_factory):
    """The port's CLI on the memmap recording, with the warm start of every
    window kept (the CLI's own calls: a pyramid solve calls the solver
    again inside)."""
    out = str(tmp_path_factory.mktemp("port") / "flow")
    starts, solve, depth = [], pc.grid_cmax_batched, [0]

    def keep(*a, **kw):
        if depth[0] == 0:
            starts.append(kw.get("x0"))
        depth[0] += 1
        try:
            return solve(*a, **kw)
        finally:
            depth[0] -= 1

    pc.grid_cmax_batched = keep
    try:
        metrics = stream_flow.main([recs[1], "--output_dir", out, "--device",
                                    "cpu", "--render"] + ARGS)
    finally:
        pc.grid_cmax_batched = solve
    return out, metrics, starts


def test_stream_flow_matches_jax_window_by_window(recs, port_run, tmp_path,
                                                  monkeypatch):
    out, metrics, starts = port_run
    assert metrics["num_windows"] == len(starts) == 2
    assert starts[0] is None and starts[1] is not None
    it = iter(starts)
    solve, depth = jc.grid_cmax_batched, [0]

    def same_start(*a, **kw):
        if depth[0] == 0:
            x0 = next(it)
            kw["x0"] = None if x0 is None else np.asarray(x0)
        depth[0] += 1
        try:
            return solve(*a, **kw)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(jc, "grid_cmax_batched", same_start)
    ref = str(tmp_path / "jax")
    j_stream.main([recs[0], "--output_dir", ref, "--render"] + ARGS)
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref)) == [
        "flow_0000.npy", "flow_0000.png", "flow_0001.npy", "flow_0001.png",
        "metrics.json", "timestamps.txt"]
    for i in range(2):
        f = np.load(os.path.join(out, f"flow_{i:04d}.npy"))
        assert f.shape == (2, 32, 32) and f.dtype == np.float32
        assert np.isfinite(f).all()
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(out, "timestamps.txt")),
        np.loadtxt(os.path.join(ref, "timestamps.txt")))
    np.testing.assert_allclose(medians(out), medians(ref), atol=MED_ATOL)
    with open(os.path.join(ref, "metrics.json")) as f:
        want = json.load(f)
    for k in ("num_windows", "num_events"):
        assert metrics[k] == want[k]
    assert metrics["mevs_sustained"] > 0 and metrics["windows_per_s"] > 0


def test_free_running_streams_reach_the_ground_truth(recs, port_run,
                                                     tmp_path):
    ref = str(tmp_path / "jax")
    j_stream.main([recs[1], "--output_dir", ref] + ARGS)
    for m in (medians(port_run[0]), medians(ref)):
        assert np.all(np.hypot(m[:, 0] - GT[0], m[:, 1] - GT[1]) < 10.0), m
    # the port's own spans, on for its run alone: mean ms a window by name
    with open(os.path.join(port_run[0], "metrics.json")) as f:
        spans = json.load(f)["spans"]
    assert spans == port_run[1]["spans"]
    ms = spans["ms_per_window"]
    assert {"cmax.solve", "cmax.bucket", "cmax.descent", "cmax.grad",
            "cmax.grid_search", "loader.fill"} <= set(ms), ms
    assert all(v > 0 for v in ms.values()), ms
    assert ms["cmax.grad"] <= ms["cmax.descent"] <= ms["cmax.solve"]
    assert spans["h2d_mb_per_window"] > 0
    assert spans["graph_captures"] == spans["graph_replays"] == 0  # the CPU
    assert not profiling.spans_enabled()


def test_hdf5_streams_as_its_memmap_does(recs, port_run, tmp_path):
    out = str(tmp_path / "h5")
    stream_flow.main([recs[0], "--output_dir", out, "--device", "cpu"]
                     + ARGS)
    for i in range(2):
        name = f"flow_{i:04d}.npy"
        np.testing.assert_array_equal(np.load(os.path.join(out, name)),
                                      np.load(os.path.join(port_run[0],
                                                           name)))


def test_render_writes_pngs_that_decode_to_jax_levels(port_run, tmp_path):
    import matplotlib.pyplot as plt

    from event_utils_tpu.utils.util import flow2bgr_np as j_flow2bgr

    out = port_run[0]
    flow = np.load(os.path.join(out, "flow_0001.npy"))
    got = plt.imread(os.path.join(out, "flow_0001.png"))
    assert got.shape == (32, 32, 3)
    want = j_flow2bgr(flow[0], flow[1])[..., ::-1]
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), want)
    # JAX's plt.imsave of the same field: RGBA, the same levels
    jpng = str(tmp_path / "j.png")
    plt.imsave(jpng, want)
    np.testing.assert_array_equal(plt.imread(jpng)[..., :3], got)


def test_denoise_solves_the_events_jax_keeps(recs, tmp_path, monkeypatch):
    """``--denoise``: the solver gets the events JAX's filter keeps, to the
    event; the field meets JAX's test's ground-truth rule (the solve
    itself is held to JAX's above)."""
    out = str(tmp_path / "p")
    args = ["--k", "6000", "--maxiter", "20", "--roi_size", "16", "16",
            "--max_windows", "1", "--denoise", "0.05"]
    kept = {}
    for name, mod, solver, extra in (
            ("port", stream_flow, pc, ["--device", "cpu"]),
            ("jax", j_stream, jc, [])):
        solve = solver.grid_cmax_batched

        def keep(*a, _name=name, _solve=solve, **kw):
            kept[_name] = [np.asarray(v) for v in a[:4]]
            return _solve(*a, **kw)

        monkeypatch.setattr(solver, "grid_cmax_batched", keep)
        mod.main([recs[1], "--output_dir",
                  out if name == "port" else str(tmp_path / "j")]
                 + args + extra)
    assert 0 < len(kept["port"][0]) < 6000  # some events dropped
    for a, b in zip(kept["port"], kept["jax"]):
        np.testing.assert_array_equal(a, b)
    m = medians(out)[0]
    assert np.hypot(m[0] - GT[0], m[1] - GT[1]) < 10.0


def test_roi_params_to_dense_flow_matches_jax():
    g = np.random.default_rng(0)
    for (H, W), roi in (((32, 32), (16, 16)), ((30, 45), (8, 10)),
                        ((180, 240), (20, 20))):
        ny, nx = -(-H // roi[0]), -(-W // roi[1])
        params = g.normal(size=(ny * nx, 2)).astype(np.float32) * 20
        for valid in (g.uniform(size=ny * nx) < 0.7,
                      np.zeros(ny * nx, bool)):
            np.testing.assert_array_equal(
                stream_flow.roi_params_to_dense_flow(params, valid, roi,
                                                     (H, W)),
                j_stream.roi_params_to_dense_flow(params, valid, roi,
                                                  (H, W)))


def test_refusals(recs, tmp_path, monkeypatch):
    import h5py

    bare = str(tmp_path / "bare.h5")
    with h5py.File(recs[0], "r") as f, h5py.File(bare, "w") as g:
        f.copy("events", g)
    with pytest.raises(SystemExit, match="sensor_resolution"):
        stream_flow.main([bare, "--output_dir", str(tmp_path / "a"),
                          "--device", "cpu"] + ARGS)
    with pytest.raises(SystemExit, match="enough events"):
        stream_flow.main([recs[1], "--output_dir", str(tmp_path / "b"),
                          "--device", "cpu", "--min_events", "7000"]
                         + ARGS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        stream_flow.main([recs[1], "--output_dir", str(tmp_path / "c")]
                         + ARGS)
