"""The serving CLIs' chunk fetch on the CPU: a chunk of windows taken item
by item from the dataset, their voxel grids built in one batched call
(``BaseVoxelDataset.deferred_grids``), padded and copied back together.

Every fetch is held to the grids that ``dataset[i]`` builds one at a time
outside the scope, padded as the CLIs pad them, within 1e-6 of their
scale: each windowing method (``between_frames`` with empty windows),
combined and split channels, chunks of 1, 3 and 8 with a short last one,
a sensor that is no multiple of 8 and events outside it. Seeded voxel
transforms, the counter ``reconstruct.batched_windows`` and the item path
outside the scope are pinned too, and the block packing
``pack_windows`` does. ``ChunkFetch.on``, the fetch for a consumer on the
card, gives the host fetch's grids bit for bit in both branches; streaming,
it hands over the stack it built with no copy to the host and counts
``reconstruct.card_windows``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from event_utils_tpu_torch.cli import reconstruct as precon
from event_utils_tpu_torch.data_formats import memmap_packager
from event_utils_tpu_torch.data_loaders import MemMapDataset
from event_utils_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECON_PARAMS = os.path.join(REPO, "runs", "recon128v2", "params.npz")
SENSOR = (30, 37)          # padded to (32, 40)
REL = 1e-6
METHODS = {
    "k_events": {"method": "k_events", "k": 550, "sliding_window_w": 0},
    "t_seconds": {"method": "t_seconds", "t": 0.07, "sliding_window_t": 0},
    "between_frames": {"method": "between_frames", "sliding_window_w": 0},
}
# two frames before the first event: the first two between_frames windows
# are empty
FRAME_TS = np.concatenate([[0.02, 0.05], np.linspace(0.15, 0.9, 9)])


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """6,000 events over 0.1-0.9 s, ~3% of them outside the 30x37
    sensor, 11 frames with flow."""
    rng = np.random.default_rng(24)
    H, W = SENSOR
    n = 6000
    xs = rng.integers(0, W, n)
    ys = rng.integers(0, H, n)
    out = rng.random(n) < 0.03
    xs[out] = rng.choice([-2, -1, W, W + 3], out.sum())
    ys[out[::-1]] = rng.choice([-1, H, H + 2], out.sum())
    ts = np.sort(rng.uniform(0.1, 0.9, n))
    ps = rng.choice([-1, 1], n)
    path = str(tmp_path_factory.mktemp("fetch") / "rec")
    with memmap_packager(path) as pk:
        pk.set_data_available(len(FRAME_TS), len(FRAME_TS))
        pk.package_events(xs, ys, ts, ps)
        for i, ft in enumerate(FRAME_TS):
            pk.package_image(rng.integers(0, 256, SENSOR).astype(np.uint8),
                             float(ft), i)
            pk.package_flow(rng.normal(0, 5, (2,) + SENSOR)
                            .astype(np.float32), float(ft), i)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], len(FRAME_TS),
                        len(FRAME_TS), sensor_size=SENSOR)
    return path


def dataset(path, method, combined, **kw):
    return MemMapDataset(path, voxel_method=dict(METHODS[method]),
                         num_bins=5, combined_voxel_channels=combined,
                         return_events=False, return_format="numpy",
                         device="cpu", **kw)


def item_grids(ds):
    """Each window's grid from ``dataset[i]`` alone, padded."""
    return precon._pad_to_multiple_hw(torch.stack(
        [torch.as_tensor(ds[i]["voxel"]) for i in range(len(ds))])).numpy()


def assert_rel(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(got - ref).max()) <= REL * scale


def fetch_all(ds, chunk, gt_fn=None):
    voxels, gts = [], []
    for lo in range(0, len(ds), chunk):
        v, g = precon._fetch_chunk(ds, lo, min(lo + chunk, len(ds)),
                                   precon._pad_to_multiple_hw, gt_fn)
        assert v.shape[0] == min(chunk, len(ds) - lo)
        voxels.append(v)
        gts.append(g)
    return np.concatenate(voxels), gts


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("combined", [True, False], ids=["combined", "split"])
@pytest.mark.parametrize("method", list(METHODS))
def test_chunk_fetch_equals_the_item_grids(recording, method, combined,
                                           chunk):
    with dataset(recording, method, combined) as ds:
        n = len(ds)
        assert n % chunk or chunk == 1      # a short last chunk
        if method == "between_frames":
            assert ds.get_event_indices(0) == (0, 0)    # an empty window
        ref = item_grids(ds)
        got, _ = fetch_all(ds, chunk)
    assert got.shape == (n, 5 if combined else 10, 32, 40)
    assert not got[..., 30:, :].any() and not got[..., 37:].any()
    assert_rel(got, ref)


@pytest.mark.parametrize("combined", [True, False], ids=["combined", "split"])
def test_gathered_and_streamed_windows_equal_the_item_grids(
        recording, combined, monkeypatch):
    """Both branches of ``_window_source``: the whole recording gathered
    (a memmap directory is never cached) and the streaming fetch (cache
    limit 0), with each window's ground truth taken from its item."""
    args = precon.build_parser().parse_args(
        [recording, "--output_dir", "unused", "--method", "between_frames",
         "--chunk", "3", "--no_window_cache", "--device", "cpu"]
        + (["--combined_channels"] if combined else []))
    frame = (lambda ds, i, item:
             np.asarray(item["frame"], np.float32).squeeze())
    with dataset(recording, "between_frames", combined) as ds:
        n = len(ds)
        ref = item_grids(ds)
        ref_frames = np.stack([frame(ds, i, ds[i]) for i in range(n)])
        fetch, stamps = precon._window_source(
            ds, args, n, pad=precon._pad_to_multiple_hw, gt_fn=frame)
        gathered = fetch(0, n)
        monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
        fetch, streamed_stamps = precon._window_source(
            ds, args, n, pad=precon._pad_to_multiple_hw, gt_fn=frame)
        streamed = [fetch(lo, min(lo + 3, n)) for lo in range(0, n, 3)]
    np.testing.assert_array_equal(stamps, streamed_stamps)
    for voxels, frames in (gathered,
                           (np.concatenate([v for v, _ in streamed]),
                            np.concatenate([g for _, g in streamed]))):
        assert_rel(voxels, ref)
        np.testing.assert_array_equal(frames, ref_frames)


def test_a_seeded_voxel_transform_gives_the_item_grid(recording):
    """Items fetched in the scope get ``transform_voxel(grid, seed)`` with
    their own seed, as ``__getitem__`` gives it one item at a time."""
    transforms = {"RandomCrop": {"size": (24, 29)}, "RobustNorm": {}}
    with dataset(recording, "k_events", False,
                 transforms=transforms) as ds:
        ref = [np.asarray(ds.__getitem__(i, seed=100 + i)["voxel"])
               for i in range(4)]
        with ds.deferred_grids():
            items = [ds.__getitem__(i, seed=100 + i) for i in range(4)]
    for item, want in zip(items, ref):
        assert isinstance(item["voxel"], torch.Tensor)
        assert_rel(item["voxel"].numpy(), want)


def test_batched_windows_counts_the_windows_fetched(recording, monkeypatch):
    args = precon.build_parser().parse_args(
        [recording, "--output_dir", "unused", "--method", "k_events",
         "--k", "550", "--combined_channels", "--no_window_cache",
         "--device", "cpu"])
    monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        with dataset(recording, "k_events", True) as ds:
            n = len(ds)
            fetch, _ = precon._window_source(
                ds, args, n, pad=precon._pad_to_multiple_hw)
            for lo in range(0, n, 4):
                fetch(lo, min(lo + 4, n))
        taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert taken.counts == {"reconstruct.batched_windows": n}
    assert len([s for s in taken.spans
                if s.name == "reconstruct.fetch"]) == -(-n // 4)


def frame_gt(ds, i, item):
    return np.asarray(item["frame"], np.float32).squeeze()


def window_source(ds, recording, chunk=3):
    args = precon.build_parser().parse_args(
        [recording, "--output_dir", "unused", "--method", "between_frames",
         "--chunk", str(chunk), "--combined_channels", "--no_window_cache",
         "--device", "cpu"])
    return precon._window_source(ds, args, len(ds),
                                 pad=precon._pad_to_multiple_hw,
                                 gt_fn=frame_gt)[0]


@pytest.mark.parametrize("streamed", [True, False],
                         ids=["streamed", "gathered"])
def test_the_card_fetch_gives_the_host_fetchs_grids(recording, streamed,
                                                    monkeypatch):
    """``fetch.on(device, lo, hi)`` against ``fetch(lo, hi)``, chunk by
    chunk: the same grids bit for bit, as a float32 tensor on the device,
    and the same ground truth; the host fetch still gives an ndarray and
    counts no card windows. Streaming, both build the chunk once a call;
    gathered, neither builds."""
    if streamed:
        monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
    was = profiling.enable_spans(True)
    try:
        with dataset(recording, "between_frames", True) as ds:
            n = len(ds)
            fetch = window_source(ds, recording)
            profiling.take()
            host, card = [], []
            for lo in range(0, n, 3):
                hi = min(lo + 3, n)
                host.append(fetch(lo, hi))
                host_counts = profiling.take().counts
                card.append(fetch.on("cpu", lo, hi))
                card_counts = profiling.take().counts
                assert host_counts == ({"reconstruct.batched_windows":
                                        hi - lo} if streamed else {})
                assert card_counts == ({"reconstruct.batched_windows":
                                        hi - lo,
                                        "reconstruct.card_windows": hi - lo}
                                       if streamed else {})
    finally:
        profiling.enable_spans(was)
    for (voxels, gts), (grids, card_gts) in zip(host, card):
        assert isinstance(voxels, np.ndarray) and voxels.dtype == np.float32
        assert np.array(voxels).shape == (len(voxels), 5, 32, 40)
        assert isinstance(grids, torch.Tensor)
        assert grids.dtype == torch.float32 and grids.device.type == "cpu"
        np.testing.assert_array_equal(grids.numpy(), voxels)
        np.testing.assert_array_equal(card_gts, gts)


def test_the_streaming_card_fetch_makes_no_host_copy(recording,
                                                     monkeypatch):
    """Streaming, ``on`` never copies the grids to the host: it counts its
    windows under both counters, one ``reconstruct.fetch`` span a call,
    and gives the item grids."""
    from event_utils_tpu_torch import _device
    from event_utils_tpu_torch.data_loaders import base_dataset

    def no_copy(a):
        raise AssertionError("a copy to the host in the card fetch")

    monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
    was = profiling.enable_spans(True)
    try:
        with dataset(recording, "between_frames", True) as ds:
            n = len(ds)
            ref = item_grids(ds)
            fetch = window_source(ds, recording)
            profiling.take()
            monkeypatch.setattr(_device, "to_numpy", no_copy)
            monkeypatch.setattr(base_dataset, "to_numpy", no_copy)
            got = [fetch.on(torch.device("cpu"), lo, min(lo + 4, n))[0]
                   for lo in range(0, n, 4)]
            taken = profiling.take()
    finally:
        profiling.enable_spans(was)
    assert taken.counts == {"reconstruct.batched_windows": n,
                            "reconstruct.card_windows": n}
    assert [s.name for s in taken.spans] == ["reconstruct.fetch"] * len(got)
    assert_rel(torch.cat(got).numpy(), ref)


def test_outside_the_scope_an_item_builds_its_own_grid(recording,
                                                       monkeypatch):
    def no_batch(*a, **k):
        raise AssertionError("a batched build outside the scope")

    with dataset(recording, "k_events", True) as ds:
        want = ds.get_voxel_grid(*ds.get_events(*ds.get_event_indices(2)))
        monkeypatch.setattr(ds, "get_voxel_grids", no_batch)
        item = ds[2]
        assert isinstance(item["voxel"], np.ndarray)
        np.testing.assert_array_equal(item["voxel"], want.numpy())
        monkeypatch.undo()

        def no_single(*a, **k):
            raise AssertionError("a per-item build inside the scope")

        monkeypatch.setattr(ds, "get_voxel_grid", no_single)
        with ds.deferred_grids():
            inside = ds[2]
            assert "voxel" not in inside
        assert_rel(inside["voxel"].numpy(), want.numpy())


def test_the_scope_belongs_to_its_thread(recording):
    """Another thread's ``__getitem__`` during an open scope builds its own
    grid; a scope whose block raises builds nothing and closes."""
    with dataset(recording, "k_events", True) as ds:
        other = {}
        with ds.deferred_grids():
            mine = ds[1]
            thread = threading.Thread(target=lambda: other.update(ds[1]))
            thread.start()
            thread.join()
            assert isinstance(other["voxel"], np.ndarray)
        assert_rel(mine["voxel"].numpy(), other["voxel"])
        with pytest.raises(KeyError):
            with ds.deferred_grids():
                lost = ds[3]
                raise KeyError("the block fails")
        assert "voxel" not in lost
        assert isinstance(ds[3]["voxel"], np.ndarray)


def test_a_nested_scope_on_one_dataset_raises(recording):
    """A second scope on the same dataset in the same thread is refused and
    leaves the open one working; another dataset opens its own."""
    with dataset(recording, "k_events", True) as ds, \
            dataset(recording, "k_events", True) as other:
        with ds.deferred_grids():
            outer = ds[0]
            with pytest.raises(RuntimeError, match="already open"):
                with ds.deferred_grids():
                    pass
            with other.deferred_grids():
                inner = other[1]
            assert isinstance(inner["voxel"], torch.Tensor)
            assert "voxel" not in outer
        assert_rel(outer["voxel"].numpy(), np.asarray(ds[0]["voxel"]))


def test_pack_windows_pads_rows_that_weigh_nothing():
    """Ragged windows become one (4, S, N) float32 block: a short row is
    padded outside the sensor, at its own last stamp, with no weight."""
    from event_utils_tpu_torch.data_loaders.base_dataset import pack_windows
    a = (np.array([3, 4, 5]), np.array([1, 2, 0]), np.array([.1, .2, .3]),
         np.array([1, -1, 1]))
    b = (np.array([7]), np.array([8]), np.array([.5]), np.array([-1]))
    rows = pack_windows([a, b])
    assert rows.shape == (4, 2, 3) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0], np.stack(a).astype(np.float32))
    np.testing.assert_array_equal(
        rows[:, 1], np.float32([[7, -1, -1], [8, 0, 0], [.5, .5, .5],
                                [-1, 0, 0]]))


def test_reconstruct_cli_streams_through_the_batched_fetch(recording,
                                                           tmp_path,
                                                           monkeypatch):
    """The CLI end to end on the streaming branch: every window's grid
    comes from a batched build, and the frames equal a gathered run's."""
    calls = []
    real = MemMapDataset.get_voxel_grids

    def counted(self, windows, **kw):
        calls.append(len(windows))
        return real(self, windows, **kw)

    monkeypatch.setattr(MemMapDataset, "get_voxel_grids", counted)
    base = [recording, "--params", RECON_PARAMS, "--method", "k_events",
            "--k", "550", "--chunk", "4", "--npy", "--device", "cpu"]
    gathered = precon.main(base + ["--output_dir", str(tmp_path / "a")])
    monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
    streamed = precon.main(base + ["--output_dir", str(tmp_path / "b")])
    n = gathered["windows"]
    assert streamed["windows"] == n
    assert calls == [8] * (n // 8) + [n % 8] * (n % 8 > 0) \
        + [4] * (n // 4) + [n % 4] * (n % 4 > 0)
    np.testing.assert_allclose(
        np.load(os.path.join(tmp_path, "b", "frames.npy")),
        np.load(os.path.join(tmp_path, "a", "frames.npy")), rtol=0,
        atol=1e-6)
