"""The port's visualization, ``draw_objective_function`` and the
``visualize*`` / ``cmax_demo`` CLIs against the JAX package, on the CPU.

Parity is held on the arrays each figure is drawn from:

- the objective landscape against JAX's ``_get_jitted_vmap`` evaluation
  on the same grid, normalised alike (1e-4 relative to the image's
  range);
- ``motion_compensate``'s image against JAX's (1e-5), and its PNG
  (written by the standard-library writer) within one gray level of
  JAX's ``plt.imsave``;
- every 2-D visualizer's event, voxel and timestamp image (1e-5; the
  timestamp image is host numpy in both, exact);
- ``draw_plane``'s points (exact: the same numpy draws) and the mayavi
  helpers (exact);
- the registry's names and its ``RegistryError``.

Each CLI writes its PNGs here with matplotlib (``--device cpu``), and
``cmax_demo.run`` agrees with JAX's CLI loop on a small slice: the loss at
the ground truth to 1e-4 relative, each objective's argmax within 0.5
px/s, or where it is further JAX's own loss rates the port's answer no
worse than JAX's (1e-3 relative, the ROI solvers' tie rule).
"""

import os
import re

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp
import numpy as np
import pytest

import event_utils_tpu as J
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu.visualization import draw_event_stream_mayavi as jm
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.contrast_max import (draw_objective_function,
                                                linvel_warp)
from event_utils_tpu_torch.convert import objective_from_jax
from event_utils_tpu_torch.errors import RegistryError
from event_utils_tpu_torch.utils.util import gray_levels, normalize_image
from event_utils_tpu_torch.visualization import (VISUALIZER_REGISTRY,
                                                 draw_event_stream_mayavi as pm,
                                                 draw_plane, get_visualizer,
                                                 motion_compensate)

from conftest import make_events
from test_torch_roi import flow_scene

CPU = "cpu"
SENSOR = (24, 32)
PLANTED = (60.0, -35.0)


@pytest.fixture(scope="module")
def scene():
    return flow_scene(np.random.default_rng(11), *PLANTED, 3000, (60, 80),
                      t_max=0.25)


@pytest.mark.parametrize("name", ["variance", "sos"])
def test_objective_landscape_matches_jax(scene, name):
    kw = {"minimum_events": 1} if name == "variance" else {}
    jobj = J.models.get_objective(name, **kw)
    xr, yr, res, img_size = (-200, 200), (-200, 200), 20, (60, 80)
    got = pc._objective_landscape(*scene, objective_from_jax(jobj),
                                  linvel_warp(), x_range=xr, y_range=yr,
                                  resolution=res, img_size=img_size,
                                  device=CPU).numpy()
    vys, vxs = np.meshgrid(np.arange(20), np.arange(20), indexing="ij")
    coords = np.stack([vxs.ravel() * res + xr[0], vys.ravel() * res + yr[0]],
                      -1)
    vloss = jc._get_jitted_vmap(jobj, J.models.linvel_warp(), img_size, 0.0)
    evals = vloss(jnp.asarray(coords, jnp.float32),
                  *(jnp.asarray(a, jnp.float32) for a in scene))
    ref = -np.asarray(evals).reshape(20, 20)
    ref = (ref - ref.min()) / ((ref.max() - ref.min()) + 1e-6)
    assert got.shape == (20, 20)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    if name == "variance":   # the peak sits within one cell of the planted
        iy, ix = np.unravel_index(np.argmax(got), got.shape)
        assert abs(ix * res + xr[0] - PLANTED[0]) <= res
        assert abs(iy * res + yr[0] - PLANTED[1]) <= res


def test_draw_objective_function_plots_its_landscape(scene, tmp_path):
    out = str(tmp_path / "landscape.png")
    img = draw_objective_function(*scene, img_size=(60, 80), gt=PLANTED,
                                  show=False, save_path=out, device=CPU)
    ref = pc._objective_landscape(*scene, pc.variance_objective(
        minimum_events=1), linvel_warp(), img_size=(60, 80), device=CPU)
    np.testing.assert_array_equal(img, ref.numpy())
    assert os.path.getsize(out) > 1000
    matplotlib.pyplot.close("all")


def test_motion_compensate_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    xs, ys, ts, ps = make_events(rng, n=2000, sensor=SENSOR,
                                 int_coords=False)
    yy, xx = np.mgrid[0:SENSOR[0], 0:SENSOR[1]]
    flow = np.stack([20 + 0.5 * xx, -10 + 0.3 * yy]).astype(np.float32)
    crop = [2, 20, 3, 30]
    for kw in ({}, {"forward_flow": False}, {"crop": crop}):
        jout, pout = str(tmp_path / "j.png"), str(tmp_path / "p.png")
        ref = J.visualization.motion_compensate(xs, ys, ts, ps, flow,
                                                fname=jout, **kw)
        got = motion_compensate(xs, ys, ts, ps, flow, fname=pout,
                                device=CPU, **kw)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
        decoded = matplotlib.image.imread(pout)
        np.testing.assert_array_equal(np.round(decoded * 255),
                                      gray_levels(normalize_image(got)))
        jlev = np.round(matplotlib.image.imread(jout)[..., 0] * 255)
        assert np.abs(jlev - np.round(decoded * 255)).max() <= 1
    assert motion_compensate(xs, ys, ts, ps, flow[None], device=CPU).shape \
        == (SENSOR[0] + 1, SENSOR[1] + 1)


def window_data(seed=4):
    xs, ys, ts, ps = make_events(np.random.default_rng(seed), n=1500,
                                 sensor=SENSOR)
    return {"events": np.stack([xs, ys, ts, ps], 1).astype(np.float64),
            "frame": [], "frame_ts": []}


def jax_image(name, data):
    """The array JAX's visualizer draws for ``data``."""
    from event_utils_tpu.representations import (TimestampImage,
                                                 events_to_image,
                                                 events_to_voxel)
    from event_utils_tpu.representations.voxel_grid import (
        get_voxel_grid_as_image)
    from event_utils_tpu.utils.util import normalize_image

    ev = data["events"]
    xs, ys, ts, ps = (ev[:, 0].astype(int), ev[:, 1].astype(int), ev[:, 2],
                      ev[:, 3])
    if name == "event_image":
        return normalize_image(np.asarray(events_to_image(
            xs, ys, ps, sensor_size=SENSOR)))
    if name == "voxel_image":
        return get_voxel_grid_as_image(np.asarray(events_to_voxel(
            xs, ys, ts, ps, 5, sensor_size=SENSOR)))
    ti = TimestampImage(SENSOR)
    ti.set_init(ts[0])
    ti.add_events(xs, ys, ts, ps)
    return ti.get_image()


@pytest.mark.parametrize("name", ["event_image", "voxel_image", "ts_image"])
def test_visualizer_images_match_jax(name, tmp_path):
    data = window_data()
    viz = get_visualizer(name, SENSOR, device=CPU)
    got = viz.image(data)
    ref = jax_image(name, data)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(),
                                                          1.0))
    out = str(tmp_path / f"{name}.png")
    viz.plot_events(data, out)
    assert os.path.getsize(out) > 500


def test_registry_names_and_error():
    assert list(VISUALIZER_REGISTRY) == list(
        J.visualization.VISUALIZER_REGISTRY)
    for name in VISUALIZER_REGISTRY:
        assert type(get_visualizer(name, SENSOR, device=CPU)).__name__ == \
            type(J.visualization.get_visualizer(name, SENSOR)).__name__
    with pytest.raises(RegistryError, match="nope") as err:
        get_visualizer("nope", SENSOR)
    assert isinstance(err.value, KeyError)


def test_draw_plane_points_match_jax(tmp_path):
    ax = J.visualization.draw_plane_figure(seed=3, n_events=300)
    jx, jt, jy = (np.asarray(a) for a in ax.collections[0]._offsets3d)
    xs, ys, ts, ps = draw_plane.plane_points(n_events=300, seed=3)
    np.testing.assert_array_equal(xs, jx)
    np.testing.assert_array_equal(ts, jt)
    np.testing.assert_array_equal(ys, jy)
    for simple in (False, True):
        out = str(tmp_path / f"plane{simple:d}.png")
        draw_plane.draw_plane_figure(save_path=out, simple=simple)
        assert os.path.getsize(out) > 1000


def test_mayavi_helpers_match_jax():
    ts = np.linspace(1.0, 2.0, 100)
    xs = np.arange(100.0)
    ys = np.arange(100.0)
    ps = np.where(np.arange(100) % 2 == 0, 1.0, -1.0)
    fts = np.asarray([1.2, 1.7])
    got = pm.pad_sliding_head(xs, ys, ts, ps, fts, dt=0.2, sdt=0.05)
    ref = jm.pad_sliding_head(xs, ys, ts, ps, fts, dt=0.2, sdt=0.05)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert pm.sliding_windows(got[2], got[4], 0.2, 0.1) == \
        jm.sliding_windows(ref[2], ref[4], 0.2, 0.1)
    for a, b in zip(pm.event_colors_lut(got[3]), jm.event_colors_lut(ref[3])):
        np.testing.assert_array_equal(a, b)
    assert pm.available() == jm.available()
    if not pm.available():
        with pytest.raises(ImportError, match="mayavi"):
            pm.plot_events(xs, ys, ts, ps)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    """``tests/test_cli.py``'s recording: 4000 events over 0.5 s, 3 frames."""
    from event_utils_tpu_torch.data_formats import hdf5_packager
    rng = np.random.default_rng(0)
    xs, ys, ts, ps = make_events(rng, n=4000, sensor=SENSOR, t_max=0.5)
    path = str(tmp_path_factory.mktemp("cli") / "scene.h5")
    ep = hdf5_packager(path)
    ep.set_data_available(3, 0)
    ep.package_events(xs, ys, ts, ps > 0)
    for i, ft in enumerate((0.1, 0.25, 0.4)):
        ep.package_image(np.zeros(SENSOR, np.uint8), ft, i)
    ep.add_metadata(len(xs), int((ps > 0).sum()), int((ps <= 0).sum()),
                    0.5, 0.0, 0.5, 3, 0, sensor_size=SENSOR)
    ep.close()
    return path


CLI_CASES = {
    "visualize_event_image": ("visualize", [
        "--visualization", "event_image", "--w_width", "0.2",
        "--end_frame", "2"], 2),
    "visualize_voxel_image": ("visualize", [
        "--visualization", "voxel_image", "--w_width", "0.2",
        "--end_frame", "1"], 1),
    "visualize_events_sliding": ("visualize_events", [
        "--plot_method", "t_seconds", "--w_width", "0.2", "--num_show",
        "200"], 1),
    "visualize_events_k_events": ("visualize_events", [
        "--plot_method", "k_events", "--num_events", "2000", "--num_show",
        "500"], 2),
    "visualize_voxel": ("visualize_voxel", [
        "--plot_method", "k_events", "--num_events", "2000"], 2),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_visualization_clis_write_their_figures(case, h5_path, tmp_path):
    import importlib

    module, argv, at_least = CLI_CASES[case]
    main = importlib.import_module(f"event_utils_tpu_torch.cli.{module}").main
    out = str(tmp_path / "out")
    main([h5_path, "--output_path", out, "--device", "cpu"] + argv)
    assert len(os.listdir(out)) >= at_least
    matplotlib.pyplot.close("all")


def test_visualize_flow_cli(h5_path, tmp_path):
    from event_utils_tpu_torch.cli.visualize_flow import main
    flow_dir = tmp_path / "flows"
    flow_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        np.save(str(flow_dir / f"flow_{i:04d}.npy"),
                rng.normal(size=(2,) + SENSOR).astype(np.float32))
    np.savetxt(str(flow_dir / "timestamps.txt"), np.array([0.1, 0.25, 0.4]))
    out = str(tmp_path / "fviz")
    main([h5_path, "--flow_path", str(flow_dir), "--output_path", out,
          "--num_show", "200", "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert "flow_000000000_compensated.png" in names
    assert any(n.endswith("_3d.png") for n in names)


def test_cmax_demo_run_matches_the_jax_cli(h5_path, capsys):
    from event_utils_tpu.cli.cmax_demo import main as j_main
    from event_utils_tpu_torch.cli import cmax_demo

    argv = [h5_path, "--start_idx", "0", "--num_events", "1500",
            "--img_size", str(SENSOR[0]), str(SENSOR[1]), "--gt", "3", "-2"]
    j_main(argv)
    printed = capsys.readouterr().out
    got = cmax_demo.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.count("gt_loss=") == len(got)
    xs, ys, ts, ps = cmax_demo.read_slice(h5_path, 0, 1500)
    for name, r in got.items():
        m = re.search(rf"^{name}: argmax=\[([^\]]*)\] loss=(\S+) "
                      rf"gt_loss=(\S+)$", printed, re.M)
        j_arg = np.array(m.group(1).split(), np.float32)
        np.testing.assert_allclose(r["gt_loss"], float(m.group(3)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        if np.abs(r["argmax"] - j_arg).max() > 0.5:
            # printed rounded to 0.01: JAX's own loss at both answers
            jobj = J.models.get_objective(name)
            at = [jobj.evaluate_function(np.asarray(a), xs, ys, ts, ps,
                                         J.models.linvel_warp(),
                                         img_size=SENSOR)
                  for a in (r["argmax"], j_arg)]
            assert at[0] <= at[1] + 1e-3 * abs(at[1]), (name, r, j_arg, at)
