"""The port's simulate CLI against the JAX package's, on the CPU.

Each scene on a 32x32 sensor: the JAX CLI draws its texture from the seed,
the port's CLI gets the same texture through ``--texture``. Held: the same
``gt.json``, frames within one 8-bit level, flows to 1e-5, event counts
within 0.1%, in memmap and ``.h5`` output; the ``--num_sequences``
factory's file names and per-sequence parameters (the same numpy draws);
the port's own contracts (``--frame_fps > --fps``, ``--texture`` checks, a
missing card).
"""

import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from event_utils_tpu.cli import simulate as jsim
from event_utils_tpu.simulation.esim import smooth_texture
from event_utils_tpu_torch.cli import simulate as psim
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DeviceUnavailableError)

SENSOR = ["--sensor", "32", "32"]
COMMON = ["--duration", "0.15", "--fps", "100", "--frame_fps", "20",
          "--c_pos", "0.15", "--c_neg", "0.15", "--octaves", "3"]
SCENES = {
    "translate": ["--scene", "translate", "--velocity", "28", "-17"],
    "rotate": ["--scene", "rotate", "--omega", "3.0"],
    "similarity": ["--scene", "similarity", "--omega", "4.0",
                   "--divergence", "0.35", "--velocity", "24", "-15"],
}


def jax_texture(tmp_path, seed, shape=(32, 32), octaves=3):
    """The JAX CLI's texture for ``seed`` as a ``--texture`` file."""
    tex_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    path = str(tmp_path / f"tex{seed}.npy")
    np.save(path, np.asarray(smooth_texture(tex_key, shape, octaves=octaves),
                             np.float32))
    return path


def read_memmap(path):
    out = {k: np.load(os.path.join(path, f"{k}.npy"))
           for k in ("t", "xy", "p", "images", "timestamps", "optic_flow")}
    with open(os.path.join(path, "gt.json")) as f:
        out["gt"] = json.load(f)
    return out


def read_h5(path):
    with h5py.File(path, "r") as f:
        images = sorted(f["images"])
        flows = sorted(f["flow"])
        out = {"t": f["events/ts"][:], "images": np.stack(
            [f["images"][k][:] for k in images]), "optic_flow": np.stack(
            [f["flow"][k][:] for k in flows]), "timestamps": np.array(
            [f["images"][k].attrs["timestamp"] for k in images]),
            "num_events": int(f.attrs["num_events"])}
    with open(path + ".gt.json") as f:
        out["gt"] = json.load(f)
    return out


def assert_recordings_agree(p, j):
    assert p["gt"] == j["gt"]
    n_j = len(j["t"])
    assert n_j > 200
    assert abs(len(p["t"]) - n_j) <= 1e-3 * n_j
    np.testing.assert_array_equal(p["timestamps"], j["timestamps"])
    assert p["images"].dtype == np.uint8 and p["images"].shape == \
        j["images"].shape
    assert np.abs(p["images"].astype(int) - j["images"].astype(int)).max() \
        <= 1
    np.testing.assert_allclose(p["optic_flow"], j["optic_flow"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_memmap_recording_matches_jax(tmp_path, scene):
    args = SENSOR + COMMON + SCENES[scene] + ["--seed", "5"]
    jsim.main([str(tmp_path / "j")] + args)
    summary = psim.main([str(tmp_path / "p"), "--device", "cpu",
                         "--texture", jax_texture(tmp_path, 5)] + args)
    p, j = read_memmap(str(tmp_path / "p")), read_memmap(str(tmp_path / "j"))
    assert_recordings_agree(p, j)
    assert summary["events"] == len(p["t"]) and summary["gt"] == p["gt"]
    np.testing.assert_array_equal(summary["frame_ts"], p["timestamps"])
    with open(tmp_path / "p" / "metadata.json") as f:
        meta = json.load(f)
    assert meta["sensor_resolution"] == [32, 32]
    assert meta["num_events"] == len(p["t"])


def test_h5_recording_matches_jax(tmp_path):
    args = SENSOR + COMMON + SCENES["translate"] + ["--seed", "3"]
    jsim.main([str(tmp_path / "j.h5")] + args)
    psim.main([str(tmp_path / "p.h5"), "--device", "cpu", "--texture",
               jax_texture(tmp_path, 3)] + args)
    p, j = read_h5(str(tmp_path / "p.h5")), read_h5(str(tmp_path / "j.h5"))
    assert_recordings_agree(p, j)
    assert p["num_events"] == len(p["t"])


def test_num_sequences_factory_matches_jax(tmp_path):
    """N recordings seq_000.h5..: the same names and per-sequence motion
    (the same numpy draws from --seed); textures are each seed's own."""
    args = ["--sensor", "16", "16", "--duration", "0.05", "--fps", "60",
            "--frame_fps", "20", "--octaves", "2", "--num_sequences", "3",
            "--seed", "11"]
    for scene in ("translate", "similarity"):
        extra = SCENES[scene]
        jdir, pdir = tmp_path / f"j_{scene}", tmp_path / f"p_{scene}"
        jsim.main([str(jdir)] + args + extra)
        psim.main([str(pdir), "--device", "cpu"] + args + extra)
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
        for i in range(3):
            name = f"seq_{i:03d}.h5.gt.json"
            with open(pdir / name) as f, open(jdir / name) as g:
                pg, jg = json.load(f), json.load(g)
            assert pg == jg and pg["seed"] == 11 + i
    with pytest.raises(ConfigurationError):
        psim.main([str(tmp_path / "x"), "--device", "cpu", "--texture",
                   jax_texture(tmp_path, 11, (16, 16), 2)] + args)


def test_cli_contracts(tmp_path):
    with pytest.raises(ConfigurationError):
        psim.main([str(tmp_path / "x.h5"), "--fps", "50", "--frame_fps",
                   "100", "--device", "cpu"])
    with pytest.raises(ConfigurationError):  # texture of another shape
        psim.main([str(tmp_path / "y"), "--device", "cpu", "--texture",
                   jax_texture(tmp_path, 1, (16, 16))] + SENSOR + COMMON)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            psim.main([str(tmp_path / "z")] + SENSOR + COMMON)


def test_seeded_texture_and_noise_run(tmp_path):
    """Without --texture the port draws its own (deterministic per seed);
    noise flags need no key and write the same recording twice."""
    args = SENSOR + COMMON + ["--seed", "2", "--leak_rate", "5",
                              "--sigma_c", "0.05", "--device", "cpu"]
    a = psim.main([str(tmp_path / "a")] + args)
    b = psim.main([str(tmp_path / "b")] + args)
    assert a["events"] == b["events"] and a["stats"]["num_noise"] > 0
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "t.npy"),
                                  np.load(tmp_path / "b" / "t.npy"))
