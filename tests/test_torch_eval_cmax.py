"""The port's eval_cmax CLI against the JAX package's, on the CPU.

Recordings made by the JAX simulate CLI (48x64, a similarity and a
translate scene) go through both CLIs at 2 windows with 12x12 ROIs: the
same ROI count, and medians within 0.5 px/s (the per-ROI descents of the
two packages part after a few steps: ``ROADMAP.md`` queue 3, "Per-ROI
parity depends on the basin";
``tests/test_torch_roi_solvers.py`` holds medians to the same 0.5).
"""

import json

import pytest
import torch

from event_utils_tpu.cli import eval_cmax as jev
from event_utils_tpu.cli import simulate as jsim
from event_utils_tpu_torch.cli import eval_cmax as pev
from event_utils_tpu_torch.errors import DeviceUnavailableError

MEDIAN_TOL = 0.5  # px/s
SCENES = {
    "similarity": ["--scene", "similarity", "--omega", "3.0",
                   "--divergence", "0.3"],
    "translate": ["--scene", "translate", "--velocity", "40", "-25"],
}


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    out = {}
    for name, scene in SCENES.items():
        path = str(tmp_path_factory.mktemp("cmax") / name)
        jsim.main([path, "--format", "memmap", "--sensor", "48", "64",
                   "--duration", "0.3", "--fps", "100", "--frame_fps", "10",
                   "--c_pos", "0.15", "--c_neg", "0.15", "--octaves", "3",
                   "--seed", "4"] + scene)
        out[name] = path
    return out


@pytest.mark.parametrize("scene, method, extra", [
    ("similarity", "k_events", ["--k", "6000"]),
    ("translate", "between_frames", []),
])
def test_medians_and_roi_counts_match_jax(recordings, tmp_path, scene,
                                          method, extra):
    args = [recordings[scene], "--method", method, "--roi_size", "12", "12",
            "--max_windows", "2"] + extra
    jev.main(args + ["--output", str(tmp_path / "j.json")])
    got = pev.main(args + ["--output", str(tmp_path / "p.json"),
                           "--device", "cpu"])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == {k: got[k] for k in want}
    assert got["windows"] == 2
    assert got["num_rois"] == want["num_rois"] > 20
    assert got["roi_size"] == want["roi_size"] == [12, 12]
    assert abs(got["median_aee_px_s"] - want["median_aee_px_s"]) \
        <= MEDIAN_TOL


def test_parser_and_device(recordings):
    rec = recordings["translate"]
    with pytest.raises(SystemExit):
        pev.build_parser().parse_args([rec, "--pyramid", "two"])
    assert pev.build_parser().parse_args(
        [rec, "--pyramid", "auto"]).pyramid == "auto"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            pev.main([rec, "--max_windows", "1"])
