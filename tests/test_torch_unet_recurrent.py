"""The port's ``UNetRecurrent`` (rpg_e2vid's E2VID network) against the
plain reference in ``tests/e2vid_reference.py``, on the CPU, through the
port's normal path: ``ReconstructionTrainer`` and ``cli/reconstruct.py``.
The reference builds the network from its settings alone and draws the
weights; the port loads them, key for key and shape for shape.

Tolerances: images 1e-5 absolute and states 1e-5 of each tensor's largest
magnitude. Both sides compute in float32 from the same weights and the
same inputs, so they can differ only where the order of float32
accumulation does. On the CPU they agree bit for bit, except in the first
convolutions a process runs: there the convolution library may take
another kernel, and that difference, carried through four recurrent
windows, read up to 2.64e-5 on a level's state (three runs of the first
comparison in a fresh process: 1.91e-5, 2.64e-5, 0). ``warm_convolutions``
runs one window of each side first, after which every comparison here read
0 in three runs.
"""

import filecmp
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import e2vid_reference as ref
from event_utils_tpu_torch.data_formats import memmap_packager
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.models.networks import (PadConv, UNetRecurrent,
                                                   same_conv2d)
from event_utils_tpu_torch.training.checkpointing import save_params_npz
from event_utils_tpu_torch.training.reconstruction import \
    ReconstructionTrainer
from event_utils_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
PUBLISHED = {"architecture": "UNetRecurrent"}
SMALL = {"architecture": "UNetRecurrent", "base_num_channels": 8,
         "num_encoders": 2, "num_residual_blocks": 1}


def net(kwargs):
    """The reference's settings for the trainer's ``kwargs``
    (rpg_e2vid's defaults where unset)."""
    return {"num_bins": 5,
            "base_num_channels": kwargs.get("base_num_channels", 32),
            "num_encoders": kwargs.get("num_encoders", 3),
            "num_residual_blocks": kwargs.get("num_residual_blocks", 2)}
IMG_ABS = 1e-5
STATE_REL = 1e-5


def trainer(kwargs, hw, seed=3):
    """The port's trainer for ``kwargs``, with the reference's weights
    drawn from ``seed`` loaded strictly; returns ``(trainer, weights)``."""
    t = ReconstructionTrainer(hw, num_bins=5, combined_channels=True,
                              model_kwargs=kwargs, seed=seed, device="cpu")
    params = ref.init_params(net(kwargs), seed)
    t.model.load_state_dict(params)
    return t, params


def random_state(model, hw, gen):
    """An ``(h, c)`` pair a level: ``h`` in (-1, 1) as a ConvLSTM's, ``c``
    of a few units."""
    return tuple((torch.rand(s, generator=gen) * 2 - 1,
                  torch.randn(s, generator=gen) * 2)
                 for s, _ in model.state_shapes(1, *hw))


def assert_state_close(got, want):
    assert len(got) == len(want)
    for pair, want_pair in zip(got, want):
        for a, b in zip(pair, want_pair):
            assert a.shape == b.shape
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= STATE_REL, err


@pytest.fixture(scope="module", autouse=True)
def warm_convolutions():
    """One throwaway window of the port and of the reference, so that no
    comparison meets the convolution library's first calls."""
    t, params = trainer(PUBLISHED, (24, 32))
    t.reconstruct(torch.zeros(1, 1, 5, 24, 32))
    ref.run(params, torch.zeros(1, 5, 24, 32), net(PUBLISHED))


def test_published_settings_have_rpg_e2vids_parameter_count():
    t, params = trainer(PUBLISHED, (24, 32))
    assert isinstance(t.model, UNetRecurrent)
    assert sum(p.numel() for p in t.model.parameters()) == 10_710_401
    assert ref.num_parameters(net(PUBLISHED)) == 10_710_401
    assert {k: tuple(v.shape) for k, v in t.model.state_dict().items()} \
        == ref.param_shapes(net(PUBLISHED))
    # rpg_e2vid's state-dict keys, without its ``unetrecurrent.`` prefix
    names = set(t.model.state_dict())
    assert {"head.conv2d.weight", "encoders.2.recurrent_block.Gates.weight",
            "resblocks.1.conv2.bias", "decoders.0.conv2d.weight",
            "pred.conv2d.bias"} <= names
    assert tuple(t.model.state_dict()[
        "encoders.2.recurrent_block.Gates.weight"].shape) == (1024, 512, 3, 3)


@pytest.mark.parametrize("warm", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("kwargs,hw", [(PUBLISHED, (24, 32)),
                                       (SMALL, (32, 48))],
                         ids=["published", "small"])
def test_matches_the_reference_over_four_windows(kwargs, hw, warm):
    t, params = trainer(kwargs, hw)
    gen = torch.Generator().manual_seed(11)
    voxels = torch.randn(4, 1, 5, *hw, generator=gen) * 2
    state0 = random_state(t.model, hw, gen) if warm else None
    images, state = t.reconstruct(voxels, state0)
    assert images.shape == (4, 1, 1) + hw
    want, want_state = ref.run(params, voxels[:, 0], net(kwargs),
                               state0)
    err = float(np.abs(images[:, 0, 0].numpy() - want).max())
    assert err <= IMG_ABS, err
    assert_state_close(state, want_state)
    # the check sees the network: images spread, every level's state moves
    assert float(images.std()) > 0.05
    for h, c in state:
        assert float(h.abs().mean()) > 1e-3 and float(c.abs().mean()) > 1e-3


def test_stride2_5x5_pads_symmetrically_not_as_same():
    """rpg_e2vid's ``nn.Conv2d(padding=2)``; flax's ``SAME`` would pad 1
    before and 2 after on an even input and shift the output a pixel."""
    gen = torch.Generator().manual_seed(5)
    conv = PadConv(3, 4, 5, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    x = torch.randn(1, 3, 16, 20, generator=gen)
    with torch.no_grad():
        got = conv(x)
        want = F.conv2d(x, conv.weight, conv.bias, 2, 2)
        same = same_conv2d(x, conv.weight, conv.bias, 2)
    assert got.shape == want.shape == same.shape == (1, 4, 8, 10)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((got - same).abs().max()) > 1.0


def test_chunks_of_8_equal_chunks_of_3_and_5():
    hw = (24, 32)
    t, _ = trainer(PUBLISHED, hw)
    voxels = torch.randn(8, 1, 5, *hw,
                         generator=torch.Generator().manual_seed(2))
    whole, state = t.reconstruct(voxels)
    first, mid = t.reconstruct(voxels[:3])
    rest, end = t.reconstruct(voxels[3:], mid)
    torch.testing.assert_close(torch.cat([first, rest]), whole, rtol=0,
                               atol=IMG_ABS)
    assert_state_close(end, state)


def test_input_not_divisible_by_8_raises():
    t, _ = trainer(PUBLISHED, (24, 32))
    with pytest.raises(ConfigurationError):
        t.reconstruct(torch.zeros(1, 1, 5, 20, 32))


def test_unknown_architecture_raises():
    with pytest.raises(ConfigurationError):
        trainer({"architecture": "UNetFlow"}, (24, 32))


def test_reconstruct_counts_windows_and_spans_each_forward():
    t, _ = trainer(SMALL, (32, 48))
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        t.reconstruct(np.zeros((3, 2, 5, 32, 48), np.float32))
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert taken.counts == {"e2vid.windows": 6}   # nothing uploaded here
    assert [s.name for s in taken.spans] == ["e2vid.forward"] * 3


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 20x30 memmap recording of 3,000 events: six k_events windows of
    500, padded by the CLI to 24x32."""
    rng = np.random.default_rng(4)
    n = 3000
    xs, ys = rng.integers(0, 30, n), rng.integers(0, 20, n)
    ts = np.sort(rng.uniform(0.0, 0.3, n))
    ps = rng.choice([-1, 1], n)
    path = str(tmp_path_factory.mktemp("e2vid") / "rec")
    with memmap_packager(path) as pk:
        pk.package_events(xs, ys, ts, ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(20, 30))
    return path


def test_params_npz_round_trip_through_the_cli(recording, tmp_path):
    """``save_params_npz`` carries the architecture; ``--params`` rebuilds
    ``UNetRecurrent`` and its frames are the reference's over the
    reference's own voxel grids, the state carried across chunks of 4."""
    from event_utils_tpu_torch.cli import reconstruct as cli
    t, weights = trainer(PUBLISHED, (24, 32), seed=8)
    params = str(tmp_path / "params.npz")
    save_params_npz(t, params)
    back = ReconstructionTrainer((24, 32), num_bins=5, combined_channels=True,
                                 model_kwargs=PUBLISHED, seed=1, device="cpu")
    assert back.load_params(params) == 0
    for k, v in t.inference_params.items():
        torch.testing.assert_close(back.inference_params[k], v, rtol=0,
                                   atol=0)
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        out = cli.main([recording, "--output_dir", str(tmp_path / "out"),
                        "--params", params, "--method", "k_events", "--k",
                        "500", "--num_bins", "5", "--combined_channels",
                        "--chunk", "4", "--npy", "--device", "cpu"])
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert out["windows"] == 6
    assert [s.name for s in taken.spans].count("reconstruct.fetch") == 2
    frames = np.load(str(tmp_path / "out" / "frames.npy"))
    assert frames.shape == (6, 20, 30)
    z = {k: np.load(os.path.join(recording, k + ".npy"))
         for k in ("t", "xy", "p")}
    voxels = np.stack([ref.voxel_grid(
        z["xy"][i:i + 500, 0], z["xy"][i:i + 500, 1],
        z["t"][i:i + 500, 0].astype(np.float32),
        np.where(z["p"][i:i + 500, 0] > 0, 1.0, -1.0), 5, (20, 30),
        (24, 32)).numpy() for i in range(0, 3000, 500)])
    want, _ = ref.run(weights, voxels, net(PUBLISHED))
    err = float(np.abs(frames - want[:, :20, :30]).max())
    assert err <= IMG_ABS, err


def test_the_two_copies_of_the_reference_agree():
    bench_copy = os.path.join(os.path.dirname(HERE), "e2e_bench",
                              "references", "e2vid.py")
    assert filecmp.cmp(os.path.join(HERE, "e2vid_reference.py"), bench_copy,
                       shallow=False)
