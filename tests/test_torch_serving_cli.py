"""The port's serving CLIs against the JAX package's, on the CPU.

One small memmap recording (events, frames, ground-truth flow; 30x36, so
the CLIs pad it to 32x40) made from a numpy seed goes through
``infer_flow`` and ``reconstruct`` of both packages with the committed
weights (``runs/flow128_similarity/params.npz``,
``runs/recon128v2/params.npz``). Flow fields and frames agree to 1e-4 of
their scale, ``metrics.json`` values to 1e-3 of theirs, the PNG frames to
one 8-bit level. The port's own contracts are pinned too: ``--ckpt_dir``
raises, a missing card raises, the PNG writer, the H5 window cache.
"""

import json
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import event_utils_tpu.data_formats as jformats  # noqa: E402
from event_utils_tpu.cli import infer_flow as jinfer  # noqa: E402
from event_utils_tpu.cli import reconstruct as jrecon  # noqa: E402
from event_utils_tpu_torch.cli import infer_flow as pinfer  # noqa: E402
from event_utils_tpu_torch.cli import reconstruct as precon  # noqa: E402
from event_utils_tpu_torch.errors import (  # noqa: E402
    ConfigurationError, DeviceUnavailableError)
from event_utils_tpu_torch.utils import util as putil  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_PARAMS = os.path.join(REPO, "runs", "flow128_similarity", "params.npz")
RECON_PARAMS = os.path.join(REPO, "runs", "recon128v2", "params.npz")
SENSOR = (30, 36)
REL = 1e-4
METRIC_REL = 1e-3


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A memmap recording of a drifting blob texture: 5 frames, 4
    between_frames windows, a uniform ground-truth flow."""
    rng = np.random.default_rng(9)
    H, W = SENSOR
    n = 6000
    xs = rng.integers(0, W, n)
    ys = rng.integers(0, H, n)
    ts = np.sort(rng.uniform(0.0, 0.5, n))
    ps = np.where((xs + ys + (ts * 40).astype(int)) % 3 == 0, -1, 1)
    frame_ts = np.linspace(0.05, 0.45, 5)
    yy, xx = np.mgrid[0:H, 0:W]
    path = str(tmp_path_factory.mktemp("serve") / "rec")
    with jformats.memmap_packager(path) as pk:
        pk.package_events(xs, ys, ts, ps)
        for i, ft in enumerate(frame_ts):
            img = 0.5 + 0.4 * np.sin(0.3 * (xx - 20 * ft)) * np.cos(0.2 * yy)
            pk.package_image((img * 255).astype(np.uint8), float(ft), i)
            pk.package_flow(np.stack([np.full((H, W), 20.0),
                                      np.zeros((H, W))]).astype(np.float32),
                            float(ft), i)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 5, 5,
                        sensor_size=SENSOR)
    return path


def assert_rel(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(got - ref).max()) <= rel * scale


def assert_metric(got, ref):
    if isinstance(ref, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_metric(g, r)
    else:
        assert abs(got - ref) <= METRIC_REL * max(abs(ref), 1.0), (got, ref)


def run_both(module_j, module_p, args, tmp_path):
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    module_j.main(args + ["--output_dir", out_j])
    summary = module_p.main(args + ["--output_dir", out_p,
                                    "--device", "cpu"])
    assert summary["output_dir"] == out_p
    return out_j, out_p, summary


def test_infer_flow_matches_jax(recording, tmp_path):
    args = [recording, "--params", FLOW_PARAMS, "--method", "between_frames",
            "--eval_gt", "--batch_size", "3", "--no_window_cache"]
    out_j, out_p, summary = run_both(jinfer, pinfer, args, tmp_path)
    names = sorted(f for f in os.listdir(out_j) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(out_p) if f.endswith(".npy"))
    assert len(names) == summary["windows"] == 4
    ref = np.stack([np.load(os.path.join(out_j, f)) for f in names])
    got = np.stack([np.load(os.path.join(out_p, f)) for f in names])
    assert got.shape == (4, 2) + SENSOR
    assert_rel(got, ref)
    np.testing.assert_array_equal(np.loadtxt(os.path.join(out_p,
                                                          "timestamps.txt")),
                                  np.loadtxt(os.path.join(out_j,
                                                          "timestamps.txt")))
    with open(os.path.join(out_j, "metrics.json")) as f:
        mj = json.load(f)
    with open(os.path.join(out_p, "metrics.json")) as f:
        mp = json.load(f)
    assert mp == summary["metrics"]
    assert set(mp) == set(mj)
    assert mp["num_fields"] == mj["num_fields"]
    for key in ("aee_px_s", "zero_flow_aee_px_s", "aee_per_window",
                "zero_flow_aee_per_window", "voxel_mass_per_window"):
        assert_metric(mp[key], mj[key])


def test_reconstruct_matches_jax(recording, tmp_path):
    args = [recording, "--params", RECON_PARAMS, "--eval_gt", "--npy",
            "--chunk", "3", "--no_window_cache"]
    out_j, out_p, summary = run_both(jrecon, precon, args, tmp_path)
    assert summary["windows"] == 4
    got = np.load(os.path.join(out_p, "frames.npy"))
    assert got.shape == (4,) + SENSOR
    assert_rel(got, np.load(os.path.join(out_j, "frames.npy")))
    with open(os.path.join(out_j, "metrics.json")) as f:
        mj = json.load(f)
    with open(os.path.join(out_p, "metrics.json")) as f:
        mp = json.load(f)
    assert set(mp) == set(mj) and mp["num_frames"] == mj["num_frames"]
    for key in ("psnr_db", "ssim", "psnr_steady_db", "ssim_steady",
                "psnr_per_frame"):
        assert_metric(mp[key], mj[key])
    for i in range(4):
        name = f"frame_{i:05d}.png"
        mine = np.round(plt.imread(os.path.join(out_p, name)) * 255)
        theirs = np.round(plt.imread(os.path.join(out_j, name))[..., 0] * 255)
        assert mine.shape == SENSOR
        assert np.abs(mine - theirs).max() <= 1


@pytest.mark.parametrize("cli", [pinfer, precon])
def test_ckpt_dir_is_not_supported(cli, recording, tmp_path):
    with pytest.raises(ConfigurationError, match="--params"):
        cli.main([recording, "--output_dir", str(tmp_path), "--ckpt_dir",
                  str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("cli", [pinfer, precon])
def test_cli_without_a_card_raises(cli, recording, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(DeviceUnavailableError):
        cli.main([recording, "--output_dir", str(tmp_path)])


def test_gray_png_decodes_to_imsave_levels(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (23, 37))
    # exact level boundaries, the ends, and values outside [0, 1]
    img[0, :8] = [0.0, 1.0, 1 / 256, 255 / 256, 0.5, -0.2, 1.3, 128 / 256]
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    putil.write_gray_png(ours, img)
    plt.imsave(theirs, img, cmap="gray", vmin=0.0, vmax=1.0)
    mine = plt.imread(ours)
    assert mine.shape == img.shape
    ref = plt.imread(theirs)[..., 0]
    assert np.abs(np.round(mine * 255) - np.round(ref * 255)).max() <= 1
    np.testing.assert_array_equal(np.round(mine * 255),
                                  putil.gray_levels(img))


def test_window_cache_next_to_an_h5_recording(recording, tmp_path,
                                              monkeypatch):
    """An H5 recording gets the JAX package's sidecar cache: the first run
    writes it, the second reads it instead of voxelizing again."""
    from event_utils_tpu_torch.data_formats import hdf5_packager
    from event_utils_tpu_torch.data_formats import read_memmap_events

    data = read_memmap_events(recording, return_events=True)
    h5 = str(tmp_path / "rec.h5")
    with hdf5_packager(h5) as pk:
        pk.package_events(data["xy"][:, 0], data["xy"][:, 1], data["t"],
                          data["p"])
        for i, ft in enumerate(data["frame_stamps"]):
            pk.package_image(data["images"][i], float(ft), i)
            pk.package_flow(data["optic_flow"][i], float(ft), i)
        pk.add_metadata(len(data["t"]), 0, 0, 0.0, 0.0, 0.0,
                        len(data["frame_stamps"]), len(data["frame_stamps"]),
                        sensor_size=SENSOR)
    args = [h5, "--params", FLOW_PARAMS, "--method", "between_frames",
            "--eval_gt", "--device", "cpu"]
    first = pinfer.main(args + ["--output_dir", str(tmp_path / "a")])
    assert os.path.exists(h5 + ".flowcache.npz")

    def no_gathering(*a, **k):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(precon, "_gather_windows", no_gathering)
    second = pinfer.main(args + ["--output_dir", str(tmp_path / "b")])
    assert second["metrics"]["aee_per_window"] == \
        first["metrics"]["aee_per_window"]
    for i in range(first["windows"]):
        np.testing.assert_array_equal(
            np.load(tmp_path / "b" / f"flow_{i:04d}.npy"),
            np.load(tmp_path / "a" / f"flow_{i:04d}.npy"))
