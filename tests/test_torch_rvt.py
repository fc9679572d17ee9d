"""The port's RVT detector (``models/rvt.py``), RVT's stacked histogram
(``representations/histogram.py``) and the detection CLI
(``cli/detect.py``) against the benchmark's plain reference of the
``rvt-gen4`` configuration, loaded by path from
``e2e_bench/references/rvt-gen4.py``, on the CPU, through the port's
normal path. The reference builds the network from its settings alone
and draws the weights; the port loads them, key for key and shape for
shape.

Sizes: the published widths (RVT-B: 64 to 512, heads of 32, PAFPN and
head at 128) over 128x192 inputs, whose partitions are 2x3 tokens.

Tolerances: the raw predictions to 1e-4 of their largest magnitude, each
stage's ``h`` and ``c`` to 1e-4 of their own: the cell's limits. Both
sides compute in float32 from the same weights and the same inputs, so
they can differ only where the order of float32 accumulation does, and
on the CPU that order follows the convolution library's choice of kernel
for the threads it has: one process read at most 1.4e-6 of the
predictions and 5.5e-6 of the deepest state over four windows, the same
test beside five other pytest workers 1.25e-5 of a state. ``warm_up``
runs one window of each side first. A bfloat16 reference read 1.6e-2,
grid-SA computed as block-SA 0.51 and a state dropped after the first
window 0.48 of the predictions' scale. Histograms are counts and agree
exactly.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from event_utils_tpu_torch import convert
from event_utils_tpu_torch.cli import detect
from event_utils_tpu_torch.cli import reconstruct as cli
from event_utils_tpu_torch.data_formats import memmap_packager
from event_utils_tpu_torch.data_loaders import MemMapDataset
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.models import rvt
from event_utils_tpu_torch.models.networks import build_detector
from event_utils_tpu_torch.representations import (stacked_histogram,
                                                   stacked_histogram_rows)
from event_utils_tpu_torch.training.checkpointing import write_params_npz
from event_utils_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "e2e_bench", "references", "rvt-gen4.py")


def _load_reference():
    spec = importlib.util.spec_from_file_location("rvt_gen4_reference",
                                                  REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()
NET = {"model": "RVT", "num_bins": 10, "downsample": 2, "count_cutoff": 10,
       "input_channels": 20, "embed_dim": 64, "dim_multiplier": [1, 2, 4, 8],
       "stem_patch_size": 4, "partition_split_32": 2, "dim_head": 32,
       "mlp_ratio": 4, "fpn_in_stages": [2, 3, 4], "fpn_depth": 0.67,
       "head_width": 128, "num_classes": 3}
KWARGS = {"architecture": "RVT", "num_classes": 3}
HW = (128, 192)
PRED_REL = 1e-4
STATE_REL = 1e-4


def model(seed=3):
    """The port's RVT from its registry with the reference's weights drawn
    from ``seed`` loaded strictly; returns ``(model, weights)``."""
    m = build_detector(KWARGS, 20)
    params = ref.init_params(NET, seed)
    m.load_state_dict(params)
    return m, params


def histograms(n, hw=HW, seed=0, density=0.05):
    """``n`` sparse stacked histograms: counts 1..10 at a share
    ``density`` of the cells."""
    gen = torch.Generator().manual_seed(seed)
    on = torch.rand(n, 20, *hw, generator=gen) < density
    return on.float() * torch.randint(1, 11, (n, 20) + hw,
                                      generator=gen).float()


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def state_rel(got, want):
    return max(rel(a, b) for pair, wpair in zip(got, want)
               for a, b in zip(pair, wpair))


@pytest.fixture(scope="module", autouse=True)
def warm_up():
    """One throwaway window of the port and of the reference, so that no
    comparison meets the convolution library's first calls."""
    m, params = model()
    x = histograms(1)
    m.detect(x)
    ref.run(params, x.numpy(), NET)


def test_published_widths_have_rvt_bs_parameter_count():
    m = build_detector(KWARGS, 20)
    count = sum(p.numel() for p in m.parameters())
    assert count == ref.num_parameters(NET) == 18_536_856
    assert abs(count / 18.5e6 - 1) < 0.02
    stages = [sum(p.numel() for p in s.parameters())
              for s in m.backbone.stages]
    assert sum(stages) == 12_784_768
    assert sum(p.numel() for p in m.fpn.parameters()) == 3_860_992
    assert sum(p.numel() for p in m.yolox_head.parameters()) == 1_891_096


def test_default_initialisation_is_drawn_and_bounded():
    """Without loaded weights every parameter is drawn from PyTorch's
    generator as ``nn.Conv2d`` and ``nn.Linear`` draw theirs (the LSTMs'
    gates too, whose convolution starts empty), LayerScale at ones."""
    nets = []
    for _ in range(2):
        torch.manual_seed(11)
        nets.append(build_detector(KWARGS, 20))
    a, b = (dict(n.named_parameters()) for n in nets)
    for k, p in a.items():
        assert torch.isfinite(p).all() and torch.equal(p, b[k]), k
    for stage in nets[0].backbone.stages:
        w, bias = (p.detach() for p in stage.lstm.Gates.parameters())
        bound = 1 / w[0].numel() ** 0.5
        assert 0 < float(w.abs().max()) <= bound
        assert float(bias.abs().max()) <= bound
    assert all(torch.equal(p, torch.ones_like(p)) for k, p in a.items()
               if k.endswith(".gamma"))


def test_state_dict_keys_are_the_references():
    m = build_detector(KWARGS, 20)
    have = m.state_dict()
    shapes = ref.param_shapes(NET)
    buffers = {k for k in have if k.rsplit(".", 1)[-1] in (
        "running_mean", "running_var", "num_batches_tracked")}
    assert set(have) - buffers == set(shapes)
    assert all(tuple(have[k].shape) == tuple(v) for k, v in shapes.items())
    assert set(ref.init_params(NET, 0)) == set(have)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_matches_the_reference_over_four_windows(seed):
    """Four windows at batch 1 with the state carried: every window's raw
    predictions and, after the last, every stage's ``(h, c)``; the
    decoded boxes as the reference decodes them."""
    m, params = model(seed)
    x = histograms(4, seed=seed % 1000)
    boxes, raw, state = m.detect(x)
    want, want_state = ref.run(params, x.numpy(), NET)
    assert raw.shape == (4, 16 * 24 + 8 * 12 + 4 * 6, 8)
    assert rel(raw.numpy(), want) <= PRED_REL
    assert state_rel(state, want_state) <= STATE_REL
    wboxes = ref.decode(torch.from_numpy(want), *HW).numpy()
    assert np.allclose(boxes.numpy(), wboxes, rtol=1e-4, atol=1e-5)


def test_the_state_carries_across_calls():
    """Two calls of two windows give the four-window call's predictions
    and state: the CLI's chunks do not change the result."""
    m, _ = model()
    x = histograms(4, seed=1)
    _, raw, state = m.detect(x)
    _, raw_a, mid = m.detect(x[:2])
    _, raw_b, end = m.detect(x[2:], mid)
    assert rel(torch.cat([raw_a, raw_b]).numpy(), raw.numpy()) <= 1e-6
    assert state_rel(end, state) <= 1e-6


@pytest.mark.parametrize("fault", ["grid_as_block", "state_dropped"])
def test_faults_fail_the_tolerance(monkeypatch, fault):
    """Grid-SA computed as block-SA, or the state dropped between windows,
    moves the predictions far past the tolerance."""
    m, params = model()
    x = histograms(3, seed=2)
    want, want_state = ref.run(params, x.numpy(), NET)
    if fault == "grid_as_block":
        monkeypatch.setattr(rvt, "grid_partition", rvt.window_partition)
        monkeypatch.setattr(rvt, "grid_reverse", rvt.window_reverse)
        _, raw, state = m.detect(x)
    else:
        raws = [m.detect(x[j:j + 1])[1] for j in range(3)]
        raw, state = torch.cat(raws), m.detect(x[2:])[2]
    assert rel(raw.numpy(), want) > 100 * PRED_REL
    assert state_rel(state, want_state) > 100 * STATE_REL


def test_partitions_are_windows_and_grids():
    """Block-SA groups adjacent tokens, grid-SA tokens spaced ``(H / P_h,
    W / P_w)`` apart, and each reverse undoes its partition."""
    H, W, P = 4, 6, (2, 3)
    x = torch.arange(H * W, dtype=torch.float32).view(1, H, W, 1)
    win = rvt.window_partition(x, P)[..., 0]
    grid = rvt.grid_partition(x, P)[..., 0]
    assert win[0].tolist() == [0, 1, 2, 6, 7, 8]
    assert grid[0].tolist() == [0, 2, 4, 12, 14, 16]
    assert torch.equal(rvt.window_reverse(rvt.window_partition(x, P), P, H,
                                          W), x)
    assert torch.equal(rvt.grid_reverse(rvt.grid_partition(x, P), P, H, W),
                       x)
    assert rvt.partition_size(384, 640) == (6, 10)
    assert rvt.partition_size(*HW) == (2, 3)


@pytest.mark.parametrize("hw", [(384, 600), (96, 128), (32, 64)])
def test_sides_not_multiples_of_64_raise(hw):
    with pytest.raises(ConfigurationError, match="multiples of 64"):
        build_detector(KWARGS, 20)(torch.zeros(1, 20, *hw))


def test_unknown_detection_architecture_raises():
    with pytest.raises(ConfigurationError, match="unknown detection"):
        build_detector({"architecture": "YOLOv8"}, 20)


def test_spans_and_counters():
    m, _ = model()
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        _, _, state = m.detect(histograms(2))
        m.detect(histograms(1), state)
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert taken.counts == {"rvt.windows": 3, "rvt.resets": 1}
    names = [s.name for s in taken.spans]
    per_window = ["rvt.attn", "rvt.mlp"] * 2 * 4
    assert names.count("rvt.attn") == names.count("rvt.mlp") == 3 * 8
    assert names.count("rvt.lstm") == 3 * 4
    assert names.count("rvt.neck") == names.count("rvt.head") == 3
    assert [n for n in names[:len(per_window) + 4]
            if n != "rvt.lstm"] == per_window


class ReplayedGraphs:
    """A stand-in for CUDA graphs on the CPU: a capture runs the step once
    and keeps its outputs; a replay runs it again over the static inputs,
    recording no span or count (a graph's replay runs no Python), and
    writes the outputs in place, as a graph's replay does."""

    @staticmethod
    def engages(x):
        return not torch.is_grad_enabled()

    @staticmethod
    def capture(run):
        out = run()

        def replay():
            was = profiling.enable_spans(False)
            try:
                for o, new in zip(out, run()):
                    o.copy_(new)
            finally:
                profiling.enable_spans(was)
        return replay, out


def test_step_replays_match_the_eager_windows_and_count_as_forward(
        monkeypatch):
    """Where a step is captured and replayed, ``detect`` gives the eager
    windows' predictions and state, counts windows and resets as the eager
    forward does, captures once a shape and records the replay's span in
    place of the forward's; moving the model drops its captures."""
    m, _ = model()
    x = histograms(4, seed=4)
    want, raw_want, state_want = m.detect(x)
    monkeypatch.setattr(m, "step_graphs", ReplayedGraphs)
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        got, raw, state = m.detect(x[:3])
        more, raw3, state = m.detect(x[3:], state)
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert torch.allclose(torch.cat([raw, raw3]), raw_want, rtol=0,
                          atol=1e-6 * float(raw_want.abs().max()))
    assert torch.allclose(torch.cat([got, more]), want, rtol=1e-6, atol=1e-6)
    for (h, c), (hw, cw) in zip(state, state_want):
        assert torch.allclose(h, hw, rtol=0, atol=1e-6)
        assert torch.allclose(c, cw, rtol=0, atol=1e-5)
    assert taken.counts == {"rvt.windows": 4, "rvt.resets": 1,
                            "rvt.graph_captures": 1}
    assert {sp.name for sp in taken.spans} == {"rvt.replay"}
    assert len(m._steps) == 1
    m.to(torch.float32)
    assert m._steps == {}


def test_linear_and_layerscale_weights_round_trip_through_params_npz(
        tmp_path):
    m, params = model(seed=5)
    path = str(tmp_path / "params.npz")
    write_params_npz(m.state_dict(), path, KWARGS)
    flat = convert.state_to_flax_params(m.state_dict())
    assert flat["['params']['backbone']['stages']['0']['att_blocks']['0']"
                "['att_window']['self_attn']['qkv']['kernel']"].shape \
        == (64, 192)
    assert "['params']['backbone']['stages']['3']['att_blocks']['0']" \
        "['att_grid']['ls2']['gamma']" in flat
    other = build_detector(KWARGS, 20)
    convert.load_params_npz(other, path, KWARGS)
    for k, v in m.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


# -- the histogram ------------------------------------------------------------
def _events(n, sensor, seed, t_span=0.05):
    rng = np.random.default_rng(seed)
    H, W = sensor
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ts = np.sort(rng.uniform(1.3, 1.3 + t_span, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return xs, ys, ts, ps


def _ref_hist(xs, ys, ts, ps, sensor, net=None):
    net = dict(NET, **(net or {}))
    d = net["downsample"]
    padded = (-(-sensor[0] // d), -(-sensor[1] // d))
    return ref.stacked_histogram(xs, ys, ts, ps, net, sensor,
                                 padded).numpy()


@pytest.mark.parametrize("downsample", [1, 2])
def test_histogram_equals_the_reference_exactly(downsample):
    sensor = (45, 67)
    xs, ys, ts, ps = _events(20_000, sensor, 1)
    got = stacked_histogram(*map(torch.from_numpy, (xs, ys, ts, ps)), 10,
                            sensor, downsample=downsample).numpy()
    want = _ref_hist(xs, ys, ts, ps, sensor, {"downsample": downsample})
    assert got.shape == (20, -(-45 // downsample), -(-67 // downsample))
    assert np.array_equal(got, want)
    assert got.sum() > 0 and got.max() <= 10


def test_histogram_clips_at_10_and_keeps_polarity_major_channels():
    """25 positive events on one pixel in the last bin count 10; 3
    negative ones in the first bin count 3 in channel 0."""
    xs = np.array([5.0] * 3 + [7.0] * 25 + [1.0], np.float32)
    ys = np.array([2.0] * 3 + [4.0] * 25 + [0.0], np.float32)
    ts = np.array([0.0] * 3 + [0.0499] * 25 + [0.05], np.float32)
    ps = np.array([-1.0] * 3 + [1.0] * 25 + [1.0], np.float32)
    got = stacked_histogram(*map(torch.from_numpy, (xs, ys, ts, ps)), 10,
                            (10, 10)).numpy()
    assert got[0, 2, 5] == 3 and got[19, 4, 7] == 10 and got[19, 0, 1] == 1
    assert got.sum() == 14
    assert np.array_equal(got, _ref_hist(xs, ys, ts, ps, (10, 10),
                                         {"downsample": 1}))


def test_a_window_whose_stamps_are_all_equal_falls_in_the_first_bin():
    xs, ys, _, ps = _events(500, (20, 30), 2)
    ts = np.full(500, 2.5, np.float32)
    got = stacked_histogram(*map(torch.from_numpy, (xs, ys, ts, ps)), 10,
                            (20, 30), downsample=2).numpy()
    assert got[1:10].sum() == got[11:].sum() == 0
    assert got[0].sum() + got[10].sum() == 500
    assert np.array_equal(got, _ref_hist(xs, ys, ts, ps, (20, 30)))


def test_rows_are_each_rows_histogram_and_padding_counts_nothing():
    """Rows of several windows in one call, a short one padded as
    ``pack_windows`` pads (x -1, p 0, its last stamp), each equal to its
    window's own histogram."""
    from event_utils_tpu_torch.data_loaders.base_dataset import pack_windows
    windows = [_events(n, (30, 40), s) for n, s in ((900, 3), (400, 4),
                                                    (1, 5))]
    rows = torch.from_numpy(pack_windows(windows))
    got = stacked_histogram_rows(*rows, 10, (30, 40), downsample=2).numpy()
    for g, w in zip(got, windows):
        assert np.array_equal(g, _ref_hist(*w, (30, 40)))


# -- the dataset and the CLI --------------------------------------------------
SENSOR = (256, 384)       # halved to 128x192
T = 0.05
WINDOWS = 5


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 256x384 memmap recording of ~15,000 events over 0.25 s, drifting
    right so that the windows differ: five 50 ms windows."""
    rng = np.random.default_rng(27)
    n = 15_000
    ts = np.sort(rng.uniform(0.0, T * WINDOWS + 1e-3, n))
    xs = (rng.integers(0, 384, n) + (ts * 300).astype(int)) % 384
    ys = rng.integers(0, 256, n)
    ps = rng.choice([-1, 1], n)
    path = str(tmp_path_factory.mktemp("rvt") / "rec")
    with memmap_packager(path) as pk:
        pk.package_events(xs, ys, ts, ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=SENSOR)
    return path


def hist_dataset(path, **kw):
    kw = dict({"representation": "stacked_histogram", "downsample": 2}, **kw)
    return MemMapDataset(path, voxel_method={"method": "t_seconds", "t": T,
                                             "sliding_window_t": 0},
                         num_bins=10, return_events=False,
                         return_format="numpy", device="cpu", **kw)


def reference_histograms(path):
    """Each window's histogram from the raw recording, padded to 128x192,
    at the ``t_seconds`` bounds."""
    t = np.load(os.path.join(path, "t.npy"))[:, 0]
    xy = np.load(os.path.join(path, "xy.npy"))
    p = np.load(os.path.join(path, "p.npy"))[:, 0]
    n = int((t[-1] - t[0]) / T)
    out = []
    for i in range(n):
        a = int(np.searchsorted(t, T * i + t[0]))
        b = int(np.searchsorted(t, T * i + t[0] + T))
        out.append(ref.stacked_histogram(
            xy[a:b, 0], xy[a:b, 1], t[a:b].astype(np.float32),
            np.where(p[a:b] > 0, 1.0, -1.0), NET, SENSOR, HW).numpy())
    return np.stack(out)


def test_the_chunk_fetch_builds_the_references_histograms(recording):
    """Items alone and a chunk's batched build give the reference's
    histograms, bit for bit; ``grid_shape`` is the histogram's."""
    ds = hist_dataset(recording)
    assert ds.grid_shape() == (20, 128, 192)
    want = reference_histograms(recording)
    assert len(ds) == len(want) == WINDOWS
    pad = detect.padder(64)
    items = pad(torch.stack([torch.as_tensor(ds[i]["voxel"])
                             for i in range(len(ds))])).numpy()
    chunk, _ = cli._fetch_chunk(ds, 0, len(ds), pad)
    assert np.array_equal(items, want)
    assert np.array_equal(chunk, want)
    ds.close()


def test_a_voxel_dataset_refuses_downsampling(recording):
    with pytest.raises(ConfigurationError, match="downsample"):
        MemMapDataset(recording, num_bins=5, device="cpu", downsample=2,
                      voxel_method={"method": "k_events", "k": 1000,
                                    "sliding_window_w": 0})
    with pytest.raises(ConfigurationError, match="representation"):
        hist_dataset(recording, representation="time_surface")


def test_window_source_sizes_an_rvt_histogram_as_20x384x640_floats(
        tmp_path, monkeypatch, capsys):
    """At Gen4's 720x1280 halved and padded to multiples of 64, the cache
    decision counts 20 x 384 x 640 x 4 B a window (a voxel grid's sizing,
    10 bins at 720x1280 padded to 8, would count 36.9 MB): the recording
    is gathered at exactly that many bytes and streamed a byte below."""
    rng = np.random.default_rng(3)
    n = 4000
    ts = np.sort(rng.uniform(0.0, 0.105, n))
    ts[0], ts[-1] = 0.0, 0.105
    path = str(tmp_path / "gen4")
    with memmap_packager(path) as pk:
        pk.package_events(rng.integers(0, 1280, n), rng.integers(0, 720, n),
                          ts, rng.choice([-1, 1], n))
        pk.add_metadata(n, 0, 0, ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(720, 1280))
    ds = hist_dataset(path)
    assert ds.grid_shape() == (20, 360, 640) and len(ds) == 2
    per_win = 20 * 384 * 640 * 4
    args = detect.build_parser().parse_args([path, "--output_dir", "o"])
    for limit, gathered in ((2 * per_win, True), (2 * per_win - 1, False)):
        monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB",
                           repr(limit / 2**20))
        fetch, _ = cli._window_source(ds, args, 2, pad=detect.padder(64))
        assert (fetch.gathered is not None) is gathered
    assert f"{per_win >> 10} KiB" in capsys.readouterr().out
    ds.close()


def run_detect(recording, out, *args):
    return detect.main([recording, "--output_dir", str(out),
                        "--t", str(T), "--no_window_cache",
                        "--device", "cpu"] + list(args))


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """The reference's weights for RVT, written by ``write_params_npz``."""
    m, weights = model(seed=8)
    path = str(tmp_path_factory.mktemp("rvt_params") / "params.npz")
    write_params_npz(m.state_dict(), path, KWARGS)
    return path, weights


@pytest.mark.parametrize("chunk", [2, 8])
def test_detect_cli_is_chunk_invariant_and_the_references(recording,
                                                          weights_file,
                                                          tmp_path, chunk):
    """The CLI's predictions over the recording, in chunks of 2 or 8, are
    the reference's decoded predictions over its own histograms with the
    state carried from zero; stamps are the windows' last events."""
    path, weights = weights_file
    res = run_detect(recording, tmp_path, "--params", path, "--chunk",
                     str(chunk))
    assert res["windows"] == WINDOWS
    with np.load(res["predictions"]) as z:
        got, stamps = z["predictions"], z["timestamps"]
    raw, _ = ref.run(weights, reference_histograms(recording), NET)
    want = ref.decode(torch.from_numpy(raw), *HW).numpy()
    assert got.shape == want.shape == (WINDOWS, 504, 8)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4)
    t = np.load(os.path.join(recording, "t.npy"))[:, 0]
    ends = [np.searchsorted(t, T * i + t[0] + T) - 1 for i in range(WINDOWS)]
    assert np.array_equal(stamps, t[ends])


def test_detect_cli_the_params_file_names_the_network(recording,
                                                      weights_file):
    from event_utils_tpu_torch.cli.detect import _model_kwargs, build_parser
    path, _ = weights_file
    args = build_parser().parse_args([recording, "--output_dir", "o",
                                      "--params", path])
    assert _model_kwargs(args) == KWARGS


def test_detect_cli_runs_without_params(recording, tmp_path):
    """Without ``--params`` the CLI runs RVT-B at PyTorch's default
    initialisation over ``--t`` windows (its only window method), at its
    default bins and Gen4's halving."""
    args = detect.build_parser().parse_args([recording, "--output_dir", "o",
                                             "--t", str(T)])
    assert (args.method, args.k, args.num_bins) == ("t_seconds", None, 10)
    assert detect.DOWNSAMPLE == 2
    res = detect.main([recording, "--output_dir", str(tmp_path),
                       "--t", str(T), "--chunk", "3", "--no_window_cache",
                       "--device", "cpu"])
    with np.load(res["predictions"]) as z:
        assert z["predictions"].shape == (WINDOWS, 504, 8)
        assert np.isfinite(z["predictions"]).all()
