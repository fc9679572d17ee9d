"""The port's E-RAFT (``models/eraft.py``) against the plain reference in
``tests/eraft_reference.py``, on the CPU, through the port's normal path:
``FlowTrainer.predict_pairs`` and ``cli/infer_flow.py``. The reference
builds the network from its settings alone and draws the weights; the
port loads them, key for key and shape for shape.

Tolerances: the 1/8 field to 1e-5 of its largest magnitude, the upsampled
field to 1e-5 of its own. Both sides compute in float32 from the same
weights and the same inputs, so they can differ only where the order of
float32 accumulation does. On the CPU they agree bit for bit, except in
the first convolutions a process runs, where the convolution library may
take another kernel: there the 12 refinements carried that difference to
2.8e-6 of the upsampled field's scale and 4.1e-6 of the 1/8 field's (a
first comparison at 128x128 in a fresh process). ``warm_convolutions``
runs one pair of each side first. A bfloat16 reference read 0.17 and
0.25 of the two fields' scales, a norm in training mode 1.0 and 0.88:
both fail by four orders of magnitude.

The sizes are the smallest with the published pyramid: four levels need
the 1/8 grid's coarsest pool to be 2x2 at least, so sides of 128.
"""

import copy
import filecmp
import os

import numpy as np
import pytest
import torch

import eraft_reference as ref
from event_utils_tpu_torch.data_formats import memmap_packager
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.models import eraft
from event_utils_tpu_torch.training.checkpointing import save_params_npz
from event_utils_tpu_torch.training.loop import FlowTrainer
from event_utils_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
NET = {"num_bins": 15, "iters": 12, "feature_dim": 256, "hidden_dim": 128,
       "context_dim": 128, "corr_levels": 4, "corr_radius": 4}
KWARGS = {"architecture": "ERAFT", "iters": 12}
HW = (128, 160)
FLOW8_REL = 1e-5
FLOW_REL = 1e-5


def trainer(hw=HW, seed=3, kwargs=KWARGS):
    """The port's trainer with the reference's weights drawn from ``seed``
    loaded strictly; returns ``(trainer, weights)``."""
    t = FlowTrainer(hw, num_bins=15, combined_channels=True,
                    model_kwargs=kwargs, seed=seed, device="cpu")
    params = ref.init_params(NET, seed)
    t.model.load_state_dict(params)
    return t, params


def grids(n, hw=HW, seed=0, density=0.05):
    """``n`` sparse voxel grids of 15 bins, values of a few units."""
    gen = torch.Generator().manual_seed(seed)
    on = torch.rand(n, 15, *hw, generator=gen) < density
    return on.float() * torch.randn(n, 15, *hw, generator=gen)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def warm_convolutions():
    """One throwaway pair of the port and of the reference, so that no
    comparison meets the convolution library's first calls."""
    t, params = trainer()
    x = grids(2)
    t.predict_pairs(x[:1], x[1:])
    ref.run(params, x[:1], x[1:], NET)


def test_published_widths_have_erafts_parameter_count():
    t, _ = trainer()
    assert isinstance(t.model, eraft.ERAFT)
    assert sum(p.numel() for p in t.model.parameters()) == 5_332_800
    assert ref.num_parameters(NET) == 5_332_800
    assert {k: tuple(v.shape) for k, v in t.model.named_parameters()} \
        == ref.param_shapes(NET)


def test_state_dict_keys_are_erafts():
    t, params = trainer()
    names = set(t.model.state_dict())
    assert names == set(params)
    assert {"fnet.conv1.weight", "fnet.layer1.0.conv1.weight",
            "fnet.layer3.1.conv2.bias", "fnet.conv2.weight",
            "cnet.norm1.running_var", "cnet.layer2.0.norm3.weight",
            "cnet.layer2.0.downsample.1.running_mean",
            "cnet.layer2.0.downsample.0.weight",
            "update_block.encoder.convc1.weight",
            "update_block.encoder.conv.bias",
            "update_block.gru.convz1.weight", "update_block.gru.convq2.bias",
            "update_block.flow_head.conv1.weight",
            "update_block.mask.0.weight", "update_block.mask.2.bias"} <= names
    # instance norms without affine hold nothing
    assert not any(k.startswith("fnet.") and "norm" in k for k in names)
    sd = t.model.state_dict()
    assert tuple(sd["update_block.gru.convz1.weight"].shape) == (128, 384, 1,
                                                                  5)
    assert tuple(sd["update_block.gru.convz2.weight"].shape) == (128, 384, 5,
                                                                  1)
    assert tuple(sd["update_block.encoder.convc1.weight"].shape) == (
        256, 324, 1, 1)
    assert tuple(sd["update_block.mask.2.weight"].shape) == (576, 256, 1, 1)
    assert tuple(sd["fnet.conv1.weight"].shape) == (64, 15, 7, 7)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_the_reference_at_the_published_widths(seed):
    """Batch 2, all 12 refinements, the published widths and pyramid."""
    t, params = trainer(seed=seed + 5)
    x = grids(3, seed=seed)
    flow, flow8 = t.predict_pairs(x[:2], x[1:])
    assert flow.shape == (2, 2) + HW and flow8.shape == (2, 2, 16, 20)
    want, want8 = ref.run(params, x[:2], x[1:], NET)
    assert rel(flow8, want8) <= FLOW8_REL
    assert rel(flow, want) <= FLOW_REL
    # the check sees the network: the field is pixels, and varies
    assert 0.3 < float(flow8.abs().mean()) < 30
    assert float(flow8.std()) > 0.1
    # and every part of it: a bfloat16 reference is far outside
    bf, bf8 = ref.run(params, x[:2], x[1:], NET, dtype=torch.bfloat16)
    assert rel(bf8, want8) > 100 * FLOW8_REL
    assert rel(bf, want) > 100 * FLOW_REL


def test_the_later_grid_feeds_the_context():
    """E-RAFT's ``cnet(image2)``: the pair swapped, or the context taken
    from the earlier grid, gives another field."""
    t, _ = trainer()
    x = grids(2)
    flow8 = t.predict_pairs(x[:1], x[1:])[1]
    assert rel(t.predict_pairs(x[1:], x[:1])[1], flow8) > 1e-2
    real = t.model.encode

    def context_from_the_earlier(image1, image2):
        fmap1, fmap2, _, _ = real(image1, image2)
        return (fmap1, fmap2) + real(image1, image1)[2:]
    t.model.encode = context_from_the_earlier
    assert rel(t.predict_pairs(x[:1], x[1:])[1], flow8) > 1e-2


def test_lookup_matches_the_reference_and_keeps_rafts_offset_order():
    gen = torch.Generator().manual_seed(7)
    B, H, W = 2, 12, 16
    pyramid = [torch.randn(B * H * W, 1, H >> i, W >> i, generator=gen)
               for i in range(3)]
    coords = (eraft.coords_grid(B, H, W)
              + torch.randn(B, 2, H, W, generator=gen) * 4)
    got = eraft.lookup(pyramid, coords, 4)
    assert got.shape == (B, 3 * 81, H, W)
    torch.testing.assert_close(got, ref.lookup(pyramid, coords, 4), rtol=0,
                               atol=0)
    # a volume that reads back its own coordinates: value x + 100 y
    ys, xs = torch.meshgrid(torch.arange(H).float(), torch.arange(W).float(),
                            indexing="ij")
    plane = (xs + 100 * ys).expand(B * H * W, 1, H, W)
    at = torch.zeros(B, 2, H, W)
    at[:, 0], at[:, 1] = 7.25, 5.5
    got = eraft.lookup([plane], at, 2)[0, :, 0, 0]
    for a in range(5):
        for b in range(5):
            # channel a (2r+1) + b samples (x + a - r, y + b - r)
            want = (7.25 + a - 2) + 100 * (5.5 + b - 2)
            assert abs(float(got[a * 5 + b]) - want) < 1e-3


def test_upsampling_matches_the_reference_and_is_convex():
    gen = torch.Generator().manual_seed(9)
    flow = torch.randn(2, 2, 6, 7, generator=gen) * 3
    mask = torch.randn(2, 576, 6, 7, generator=gen)
    got = eraft.upsample_convex(flow, mask)
    assert got.shape == (2, 2, 48, 56)
    torch.testing.assert_close(got, ref.upsample(flow, mask), rtol=0,
                               atol=0)
    # a constant field stays 8x itself inside the border
    const = torch.full((1, 2, 6, 7), 1.5)
    up = eraft.upsample_convex(const, mask[:1])
    torch.testing.assert_close(up[..., 8:-8, 8:-8],
                               torch.full_like(up[..., 8:-8, 8:-8], 12.0))


def test_batch_norm_statistics_matter():
    """The context encoder's batch norms run on their eval statistics: a
    norm in training mode gives another field."""
    t, _ = trainer()
    x = grids(3)
    flow, _ = t.predict_pairs(x[:2], x[1:])
    model = copy.deepcopy(t.model).train()
    with torch.no_grad():
        wrong, _ = model(x[:2], x[1:])
    assert rel(wrong, flow) > 1e-2


def test_wide_convolutions_match_and_follow_their_weights():
    """``WideConv2d`` gives ``nn.Conv2d``'s outputs with and without
    autograd; without, its padded weights are made once and made anew
    after a load."""
    torch.manual_seed(0)
    wide = eraft.WideConv2d(256, 126, 3, padding=1)
    plain = torch.nn.Conv2d(256, 126, 3, padding=1)
    plain.load_state_dict(wide.state_dict())
    x = torch.randn(2, 256, 6, 8)
    with torch.no_grad():
        torch.testing.assert_close(wide(x), plain(x))
        padded = wide._wide[1]
        assert padded.shape[0] == eraft.WIDE_OUTPUTS
        wide(x)
        assert wide._wide[1] is padded
        plain.weight.mul_(2.0)
        plain.bias.add_(1.0)
        wide.load_state_dict(plain.state_dict())
        torch.testing.assert_close(wide(x), plain(x))
    y = wide(x)
    torch.testing.assert_close(y, plain(x))
    y.square().sum().backward()
    assert wide.weight.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [5, 8])
def test_wide_convolutions_still_pay_on_the_card(batch):
    """The motion encoder's two ``WideConv2d`` at the cell's 60x80 maps
    take under half the time of the native widths on the card; where they
    do not, cuDNN's float32 choices changed, and ``WideConv2d`` should be
    re-timed and dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: it times cuDNN's choices there")
    from event_utils_tpu_torch._device import no_tf32
    dev = torch.device("cuda")
    torch.manual_seed(0)
    x = torch.randn(batch, 256, 60, 80, device=dev)

    def ms(conv):
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            conv(x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times[2:])[2]

    for out in (192, 126):
        wide = eraft.WideConv2d(256, out, 3, padding=1).to(dev)
        plain = torch.nn.Conv2d(256, out, 3, padding=1).to(dev)
        plain.load_state_dict(wide.state_dict())
        with torch.no_grad(), no_tf32():
            native, padded = ms(plain), ms(wide)
        print(f"cuDNN {torch.backends.cudnn.version()}, {out} outputs at "
              f"batch {batch}: native {native:.3f} ms, {eraft.WIDE_OUTPUTS}"
              f" wide {padded:.3f} ms")
        assert padded < 0.5 * native, (native, padded)


@pytest.mark.parametrize("hw", [(128, 132), (124, 160), (64, 160)])
def test_sides_not_multiples_of_8_or_too_small_raise(hw):
    t, _ = trainer()
    x = torch.zeros(1, 15, *hw)
    with pytest.raises(ConfigurationError):
        t.predict_pairs(x, x)


def test_unknown_architecture_raises():
    with pytest.raises(ConfigurationError):
        FlowTrainer(HW, num_bins=15, combined_channels=True,
                    model_kwargs={"architecture": "RAFT"}, device="cpu")


def test_single_window_and_training_calls_refuse_eraft():
    t, _ = trainer()
    x = torch.zeros(2, 15, *HW)
    with pytest.raises(ConfigurationError):
        t.predict(x)
    with pytest.raises(ConfigurationError):
        t.train_batch(x, torch.zeros(2, 8, 4), torch.ones(2, 8))
    with pytest.raises(ConfigurationError):
        t.fit([])
    evflownet = FlowTrainer((32, 32), num_bins=5, device="cpu")
    with pytest.raises(ConfigurationError):
        evflownet.predict_pairs(torch.zeros(1, 10, 32, 32),
                                torch.zeros(1, 10, 32, 32))


def test_spans_and_counters():
    t, _ = trainer(kwargs={"architecture": "ERAFT", "iters": 3})
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        t.predict_pairs(grids(2), grids(2, seed=1))
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert taken.counts == {"eraft.pairs": 2, "eraft.iterations": 6}
    assert [s.name for s in taken.spans] == [
        "eraft.encode", "eraft.corr", "eraft.refine", "eraft.upsample"]


def test_the_two_copies_of_the_reference_agree():
    bench_copy = os.path.join(os.path.dirname(HERE), "e2e_bench",
                              "references", "eraft-dsec.py")
    assert filecmp.cmp(os.path.join(HERE, "eraft_reference.py"), bench_copy,
                       shallow=False)


# -- the CLI ------------------------------------------------------------------
K = 4000
WINDOWS = 7


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 128x128 memmap recording of 28,000 events over 0.7 s: seven
    k_events windows of 4,000, so six pairs."""
    rng = np.random.default_rng(25)
    n = K * WINDOWS
    ts = np.sort(rng.uniform(0.0, 0.7, n))
    # points drifting right, so that the windows differ
    xs = (rng.integers(0, 128, n) + (ts * 40).astype(int)) % 128
    ys = rng.integers(0, 128, n)
    ps = rng.choice([-1, 1], n)
    path = str(tmp_path_factory.mktemp("eraft") / "rec")
    with memmap_packager(path) as pk:
        pk.package_events(xs, ys, ts, ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(128, 128))
    return path


def infer(recording, out, *args):
    from event_utils_tpu_torch.cli import infer_flow
    return infer_flow.main([recording, "--output_dir", str(out), "--method",
                            "k_events", "--k", str(K), "--num_bins", "15",
                            "--combined_channels", "--no_window_cache",
                            "--device", "cpu"] + list(args))


def fields(out):
    files = sorted(f for f in os.listdir(out) if f.startswith("flow_"))
    return np.stack([np.load(os.path.join(out, f)) for f in files])


def reference_fields(recording, weights, iters=12):
    """The reference's fields over its own grids, in px/s: pair ``j`` over
    the time from window ``j``'s last event to window ``j + 1``'s."""
    z = {k: np.load(os.path.join(recording, k + ".npy"))
         for k in ("t", "xy", "p")}
    vox = np.stack([ref.voxel_grid(
        z["xy"][i:i + K, 0], z["xy"][i:i + K, 1],
        z["t"][i:i + K, 0].astype(np.float32),
        np.where(z["p"][i:i + K, 0] > 0, 1.0, -1.0), 15, (128, 128),
        (128, 128)).numpy() for i in range(0, K * WINDOWS, K)])
    flow, _ = ref.run(weights, vox[:-1], vox[1:], dict(NET, iters=iters))
    ends = z["t"][K - 1::K, 0]
    return flow / np.diff(ends)[:, None, None, None]


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """The reference's weights for ERAFT at 12 iterations, saved by
    ``save_params_npz``."""
    t, weights = trainer(hw=(128, 128), seed=8)
    path = str(tmp_path_factory.mktemp("eraft_params") / "params.npz")
    save_params_npz(t, path)
    return path, weights


def test_infer_flow_pairs_are_chunk_invariant_and_the_references(
        recording, weights_file, tmp_path):
    """Field ``j`` is E-RAFT(window ``j``, window ``j + 1``), the same with
    chunks of 3 pairs (the last grid carried across two chunk boundaries)
    and of 8 (one chunk), and the reference's over its own grids."""
    path, weights = weights_file
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        out3 = infer(recording, tmp_path / "b3", "--params", path,
                     "--batch_size", "3")
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    out8 = infer(recording, tmp_path / "b8", "--params", path,
                 "--batch_size", "8")
    assert out3["windows"] == out8["windows"] == WINDOWS - 1
    a, b = fields(tmp_path / "b3"), fields(tmp_path / "b8")
    assert a.shape == (WINDOWS - 1, 2, 128, 128)
    assert rel(a, b) <= FLOW_REL
    assert rel(a, reference_fields(recording, weights)) <= FLOW_REL
    stamps = np.loadtxt(tmp_path / "b3" / "timestamps.txt")
    t = np.load(os.path.join(recording, "t.npy"))[:, 0]
    np.testing.assert_array_equal(stamps, t[2 * K - 1::K])
    # each grid built once; every pair through all 12 refinements
    assert taken.counts["reconstruct.batched_windows"] == WINDOWS
    assert taken.counts["eraft.pairs"] == WINDOWS - 1
    assert taken.counts["eraft.iterations"] == 12 * (WINDOWS - 1)
    names = [s.name for s in taken.spans]
    for name in ("eraft.encode", "eraft.corr", "eraft.refine",
                 "eraft.upsample"):
        assert names.count(name) == 2, names
    assert names.count("reconstruct.fetch") == 2


def pair_source(recording, k, streamed, monkeypatch):
    """The flow CLI's chunk fetch over ``recording`` in windows of ``k``,
    its streaming branch (window-cache limit 0) or its gathered one;
    returns ``(dataset, fetch)``."""
    from event_utils_tpu_torch.cli import infer_flow
    from event_utils_tpu_torch.cli import reconstruct as cli
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    args = infer_flow.build_parser().parse_args(
        [recording, "--output_dir", "unused", "--method", "k_events", "--k",
         str(k), "--num_bins", "15", "--combined_channels",
         "--no_window_cache", "--device", "cpu"])
    ds = MemMapDataset(recording, voxel_method=cli._voxel_method(args),
                       num_bins=15, combined_voxel_channels=True,
                       return_events=False, return_format="numpy",
                       device="cpu")
    with monkeypatch.context() as m:
        if streamed:
            m.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
        fetch, _ = cli._window_source(ds, args, len(ds),
                                      pad=cli._pad_to_multiple_hw)
    return ds, fetch


def pass_of_pairs(pairs, n, chunk):
    """Every chunk of ``chunk`` pairs of a pass over ``n`` windows: the
    grids and the grid carried after each."""
    out = []
    for lo in range(0, n - 1, chunk):
        grids, gts = pairs(lo, min(lo + chunk, n - 1))
        assert gts is None
        out.append((grids, pairs.last[1]))
    return out


def test_pair_fetch_takes_the_streamed_chunk_on_the_device(recording,
                                                           monkeypatch):
    """``PairFetch`` over the streaming fetch, chunks of 3 pairs over 8
    windows (two chunk boundaries, a short last chunk): the grids and the
    carried last grid equal the host path's (a plain ``fetch(lo, hi)``,
    uploaded) bit for bit and the windows' own; each window is built once,
    and only the device path counts card windows. The carried grid holds
    no view of the chunk."""
    from event_utils_tpu_torch.cli import infer_flow
    ds, fetch = pair_source(recording, 3500, True, monkeypatch)
    with ds:
        n = len(ds)
        assert n == 8
        want = torch.from_numpy(fetch(0, n)[0])
        was = profiling.enable_spans(True)
        profiling.take()
        try:
            card = pass_of_pairs(infer_flow.PairFetch(fetch, "cpu"), n, 3)
            card_counts = profiling.take().counts
            host = pass_of_pairs(infer_flow.PairFetch(
                lambda lo, hi: fetch(lo, hi), "cpu"), n, 3)
            host_counts = profiling.take().counts
        finally:
            profiling.enable_spans(was)
    assert card_counts == {"reconstruct.batched_windows": n,
                           "reconstruct.card_windows": n}
    assert host_counts == {"reconstruct.batched_windows": n}
    for lo, (grids, last), (host_grids, host_last) in zip(
            range(0, n - 1, 3), card, host):
        hi = min(lo + 3, n - 1)
        assert grids.shape == (hi - lo + 1, 15, 128, 128)
        torch.testing.assert_close(grids, host_grids, rtol=0, atol=0)
        torch.testing.assert_close(grids, want[lo:hi + 1], rtol=0, atol=0)
        torch.testing.assert_close(last, host_last, rtol=0, atol=0)
        torch.testing.assert_close(last, want[hi:hi + 1], rtol=0, atol=0)
        assert last.untyped_storage().data_ptr() \
            != grids.untyped_storage().data_ptr()


@pytest.mark.parametrize("streamed", [True, False],
                         ids=["streamed", "gathered"])
def test_a_plain_fetch_callable_still_works_through_pair_fetch(
        recording, streamed, monkeypatch):
    """A wrapper that is only a ``fetch(lo, hi)`` callable gives the same
    grids through ``PairFetch`` as the chunk fetch itself, cold chunks
    (a jump back) included."""
    from event_utils_tpu_torch.cli import infer_flow
    ds, fetch = pair_source(recording, K, streamed, monkeypatch)
    with ds:
        own = infer_flow.PairFetch(fetch, "cpu")
        plain = infer_flow.PairFetch(lambda lo, hi: fetch(lo, hi), "cpu")
        for lo, hi in ((0, 2), (2, 4), (1, 3), (3, 6), (0, 6)):
            a, _ = own(lo, hi)
            b, _ = plain(lo, hi)
            assert a.dtype == b.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_params_round_trip_keeps_the_architecture(weights_file, tmp_path):
    path, weights = weights_file
    back = FlowTrainer((128, 128), num_bins=15, combined_channels=True,
                       model_kwargs=KWARGS, seed=1, device="cpu")
    assert back.load_params(path) == 0
    for k, v in back.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(v, weights[k], rtol=0, atol=0)
    from event_utils_tpu_torch.convert import read_model_json_npz
    assert read_model_json_npz(path) == KWARGS
    other = FlowTrainer((128, 128), num_bins=15, combined_channels=True,
                        model_kwargs={"architecture": "ERAFT", "iters": 4},
                        device="cpu")
    with pytest.raises(Exception, match="model_kwargs"):
        other.load_params(path)


def test_the_flags_and_the_params_file_must_agree(recording, weights_file,
                                                  tmp_path):
    path, _ = weights_file
    for flags in (["--architecture", "EVFlowNet"], ["--iters", "4"]):
        with pytest.raises(SystemExit):
            infer(recording, tmp_path / "x", "--params", path, *flags)
    with pytest.raises(SystemExit):
        infer(recording, tmp_path / "y", "--iters", "4")


def test_random_weights_and_iters_from_the_flags(recording, tmp_path):
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        out = infer(recording, tmp_path / "r", "--architecture", "ERAFT",
                    "--iters", "2", "--max_frames", "4")
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert out["windows"] == 3
    assert taken.counts["eraft.iterations"] == 2 * 3
    assert np.isfinite(fields(tmp_path / "r")).all()


def test_evflownet_stays_the_default(recording, tmp_path):
    """One field a window, from ``predict``, as before."""
    from event_utils_tpu_torch.cli import infer_flow
    out = infer_flow.main([recording, "--output_dir", str(tmp_path / "e"),
                           "--method", "k_events", "--k", str(K),
                           "--no_window_cache", "--device", "cpu"])
    assert out["windows"] == WINDOWS
    assert fields(tmp_path / "e").shape == (WINDOWS, 2, 128, 128)
