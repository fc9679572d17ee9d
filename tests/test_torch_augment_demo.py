"""The port's ``augment_demo`` against the JAX package's, and its
``bilinear_scatter_matmul`` against JAX's, on the CPU.

Both packages' ``main`` run on the same small HDF5 and memmap recordings
with ``plot_events`` patched in each to capture its inputs: the same six
figures, in the same order, with equal arrays (the augmentations are host
numpy from one seed, so equal means bit-identical). One run of the port's
``main`` unpatched writes the figures with matplotlib (Agg).

``bilinear_scatter_matmul``: the port computes in f32 at every precision;
JAX's one-hot matmul is bf16-factored (~1e-3 relative, 4e-3 of the
image's max |value| here) or hi/lo split (3e-5).
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from event_utils_tpu.ops.matmul_scatter import \
    bilinear_scatter_matmul as jax_bsm
from event_utils_tpu_torch.cli import augment_demo as PC
from event_utils_tpu_torch.ops import bilinear_scatter_matmul

torch.set_num_threads(1)

SENSOR = (24, 32)
REL = {"bf16": 4e-3, "hilo": 3e-5}


def scene(rng, n=3000):
    H, W = SENSOR
    xs = rng.integers(0, W, n)
    ys = rng.integers(0, H, n)
    ts = np.sort(rng.uniform(0, 0.5, n))
    ps = rng.choice(np.array([-1.0, 1.0]), n)
    return xs, ys, ts, ps


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """The same events as an HDF5 file (JAX's packager) and a memmap
    directory (the port's packager)."""
    from event_utils_tpu.data_formats import hdf5_packager
    from event_utils_tpu_torch.data_formats import memmap_packager
    xs, ys, ts, ps = scene(np.random.default_rng(0))
    root = tmp_path_factory.mktemp("augment_demo")
    h5 = str(root / "scene.h5")
    ep = hdf5_packager(h5)
    ep.set_data_available(0, 0)
    ep.package_events(xs, ys, ts, ps > 0)
    ep.add_metadata(len(xs), int((ps > 0).sum()), int((ps <= 0).sum()),
                    0.5, 0.0, 0.5, 0, 0, sensor_size=SENSOR)
    ep.close()
    mm = str(root / "scene_mm")
    mp = memmap_packager(mm)
    mp.package_events(xs, ys, ts, ps)
    mp.add_metadata(len(xs), int((ps > 0).sum()), int((ps <= 0).sum()),
                    0.5, 0.0, 0.5, 0, 0, sensor_size=SENSOR)
    return {"h5": h5, "memmap": mm}


def captured(monkeypatch, module, argv):
    """Figures ``main`` of ``module`` (a ``draw_event_stream``'s package
    prefix) would draw: ``[(name, arrays), ...]``."""
    import importlib
    draw = importlib.import_module(f"{module}.visualization.draw_event_stream")
    cli = importlib.import_module(f"{module}.cli.augment_demo")
    figs = []

    def fake(xs, ys, ts, ps, save_path=None, **kw):
        figs.append((os.path.basename(save_path),
                     [np.array(a) for a in (xs, ys, ts, ps)], kw))

    monkeypatch.setattr(draw, "plot_events", fake)
    cli.main(argv)
    return figs


@pytest.mark.parametrize("kind", ["h5", "memmap"])
def test_augment_demo_figures_equal_jax(recordings, tmp_path, monkeypatch,
                                        kind):
    argv = [recordings[kind], "--num", "1200", "--start", "100",
            "--num_compress", "50", "--sensor", "24", "32", "--to_add",
            "1.5"]
    got = captured(monkeypatch, "event_utils_tpu_torch",
                   argv + ["--output_path", str(tmp_path / "port")])
    want = captured(monkeypatch, "event_utils_tpu",
                    argv + ["--output_path", str(tmp_path / "jax")])
    assert [g[0] for g in got] == list(PC.FIGURES)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (name, arrays, kw), (_, warrays, wkw) in zip(got, want):
        assert kw == wkw, name
        for a, b in zip(arrays, warrays):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    lengths = {name: len(arrays[0]) for name, arrays, _ in got}
    assert lengths == {"raw": 1200, "add_correlated": 3000,
                       "add_random": 3000, "remove": 600, "rotate": 1200,
                       "flip_x": 1200}


def test_augment_demo_writes_the_figures(recordings, tmp_path):
    out = str(tmp_path / "figs")
    PC.main([recordings["memmap"], "--output_path", out, "--num", "400",
             "--num_compress", "20", "--sensor", "24", "32", "--to_add",
             "1.0"])
    names = sorted(os.listdir(out))
    assert names == sorted(f"{n}.png" for n in PC.FIGURES)
    assert all(os.path.getsize(os.path.join(out, n)) > 0 for n in names)


def test_augment_demo_without_matplotlib_names_it(recordings, tmp_path,
                                                  monkeypatch):
    """Where matplotlib is missing (the card's machine), ``main`` raises an
    error that names it before doing any work; no figure is skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "none")
    with pytest.raises(ImportError, match="matplotlib"):
        PC.main([recordings["h5"], "--output_path", out])
    assert not os.path.exists(out)


def test_augment_sweep_is_the_figures_inputs(recordings):
    """``augment_sweep`` (what runs without matplotlib) is what ``main``
    draws."""
    xs, ys, ts, ps = PC.load_window(recordings["h5"], SENSOR, 0, 500)
    sweep = PC.augment_sweep(xs, ys, ts, ps, SENSOR, 2.0)
    assert list(sweep) == list(PC.FIGURES)
    assert len(sweep["add_correlated"][0]) == 1500
    np.testing.assert_array_equal(sweep["flip_x"][0], 31 - xs)


def splat_inputs(rng, n=4000, K=None):
    H, W = SENSOR
    x = rng.uniform(-2, W + 1, n).astype(np.float32)
    y = rng.uniform(-2, H + 1, n).astype(np.float32)
    w = rng.normal(size=(n,) if K is None else (K, n)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return x, y, w, mask


@pytest.mark.parametrize("K", [None, 1, 4])
@pytest.mark.parametrize("precision", ["bf16", "hilo"])
def test_bilinear_scatter_matmul_matches_jax(K, precision):
    x, y, w, mask = splat_inputs(np.random.default_rng(3), K=K)
    want = np.asarray(jax_bsm(x, y, w, SENSOR, mask=mask, chunk=1024,
                              precision=precision))
    got = bilinear_scatter_matmul(x, y, w, SENSOR, mask=mask, chunk=1024,
                                  precision=precision, device="cpu")
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= REL[precision] * float(np.abs(want).max()), err


def test_bilinear_scatter_matmul_gradients_and_checks():
    """Differentiable in x, y and w (the kernel's gather VJP); an unknown
    precision is refused."""
    x, y, w, _ = splat_inputs(np.random.default_rng(4), n=500, K=2)
    xt, yt, wt = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    out = bilinear_scatter_matmul(xt, yt, wt, SENSOR)
    (out ** 2).sum().backward()
    for t in (xt, yt, wt):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    from event_utils_tpu_torch.errors import ConfigurationError
    with pytest.raises(ConfigurationError):
        bilinear_scatter_matmul(xt, yt, wt, SENSOR, precision="int8")


def test_crop_helpers_match_jax():
    from event_utils_tpu.visualization import visualization_utils as jv
    from event_utils_tpu_torch.errors import ConfigurationError
    from event_utils_tpu_torch.visualization import crop_to_size, parse_crop
    for crop in ("20x10+3+4", "1x1+0+0", None):
        assert parse_crop(crop) == jv.parse_crop(crop)
    assert crop_to_size(parse_crop("20x10+3+4")) == [10, 20]
    with pytest.raises(ConfigurationError):
        parse_crop("20x10")


def test_plot_voxel_grid_matches_jax(tmp_path):
    """The voxel render's pooled grid (what it draws) equals JAX's."""
    from event_utils_tpu.visualization import plot_voxel_grid as jax_plot
    from event_utils_tpu_torch.visualization import plot_voxel_grid
    xs, ys, ts, ps = scene(np.random.default_rng(5), n=2000)
    kw = dict(bins=4, crop=[2, 22, 4, 30], downsample=4, show_plot=False)
    got = plot_voxel_grid(xs, ys, ts, ps, save_path=str(tmp_path / "p.png"),
                          device="cpu", **kw)
    want = jax_plot(xs, ys, ts, ps, save_path=str(tmp_path / "j.png"), **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert os.path.getsize(tmp_path / "p.png") > 0


def test_plot_renderers_write_frames(tmp_path):
    """``plot_events`` with a frame (the structure layer is an event image
    on ``device``), the sliding-window and between-frames renderers."""
    import types
    from event_utils_tpu_torch.visualization import (plot_between_frames,
                                                     plot_events,
                                                     plot_events_sliding)
    xs, ys, ts, ps = scene(np.random.default_rng(6), n=1500)
    frame = np.full(SENSOR, 128, np.uint8)
    plot_events(xs, ys, ts, ps, save_path=str(tmp_path / "f.png"),
                imgs=[frame], img_ts=[0.25], num_compress=100, dpi=50,
                device="cpu")
    args = types.SimpleNamespace(
        w_width=0.2, sw_width=0.15, output_path=str(tmp_path / "slide"),
        num_show=200, event_size=2, hide_events=False, hide_frames=False,
        crop=None, compress_front=False, invert=False, num_compress=0,
        show_plot=False, show_axes=False, stride=1, elev=0, azim=45,
        skip_frames=1, hide_skipped=False, num_bins=3, device="cpu")
    plot_events_sliding(xs, ys, ts, ps, args, frames=[frame, frame],
                        frame_ts=[0.1, 0.3])
    assert len(os.listdir(args.output_path)) == 2
    args.output_path = str(tmp_path / "between")
    idx = np.array([[0, 700], [700, 1500]])
    plot_between_frames(xs, ys, ts, ps, [frame, frame], idx, args,
                        plttype="voxel")
    assert sorted(os.listdir(args.output_path)) == [
        "events_000000000.png", "events_000000001.png"]
