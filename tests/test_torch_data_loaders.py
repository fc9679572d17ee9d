"""Parity of the port's readers, packagers and windowed datasets against the
JAX package, on the CPU.

One recording (events, frames, ground-truth flow) made from a numpy seed is
written by the JAX packagers as HDF5, as a memmap directory and as an
``(N, 4)`` npy file, then read by both packages' datasets. Index tables,
frames, flows and events must be equal; voxel grids agree to 1e-5 of
their scale (f32 sums in another order), under the default ``'xla'`` and
under ``set_default_impl('pallas')`` in both packages (the JAX kernel in
interpret mode, the port's flat kernel through its plain version on CPU
tensors).
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch

import event_utils_tpu.data_formats as jformats
import event_utils_tpu.data_loaders as jloaders
from event_utils_tpu.ops import scatter as jscatter
import event_utils_tpu_torch.data_formats as pformats
import event_utils_tpu_torch.data_loaders as ploaders
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DeviceUnavailableError,
                                          RegistryError)
from event_utils_tpu_torch.ops import cuda_scatter
from event_utils_tpu_torch.ops import scatter as pscatter

SENSOR = (32, 48)
VOXEL_REL = 1e-5
METHODS = {
    "k_events": {"method": "k_events", "k": 2000, "sliding_window_w": 500},
    "t_seconds": {"method": "t_seconds", "t": 0.2, "sliding_window_t": 0.05},
    "between_frames": {"method": "between_frames"},
    "fixed_frames": {"method": "fixed_frames", "num_frames": 3},
}
DATASETS = {"memmap": "MemMapDataset", "h5": "DynamicH5Dataset",
            "npy": "NpyDataset"}


def recording(seed, sensor=SENSOR, n=8000, duration=0.8, n_frames=4):
    rng = np.random.default_rng(seed)
    H, W = sensor
    xs = rng.integers(0, W, n)
    ys = rng.integers(0, H, n)
    ts = np.sort(rng.uniform(0.0, duration, n))
    ps = rng.choice([-1, 1], n)
    frame_ts = np.linspace(0.1, duration - 0.1, n_frames)
    frames = rng.integers(0, 256, (n_frames, H, W)).astype(np.uint8)
    flows = rng.normal(0, 10, (n_frames, 2, H, W)).astype(np.float32)
    return xs, ys, ts, ps, frame_ts, frames, flows


def package(pk, rec, sensor=SENSOR):
    xs, ys, ts, ps, frame_ts, frames, flows = rec
    with pk:
        pk.set_data_available(len(frames), len(flows))
        pk.package_events(xs, ys, ts, ps)
        for i, (ft, fr, fl) in enumerate(zip(frame_ts, frames, flows)):
            pk.package_image(fr, float(ft), i)
            pk.package_flow(fl, float(ft), i)
        pk.add_metadata(len(xs), int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], len(frames),
                        len(flows), sensor_size=sensor)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec")
    rec = recording(0)
    out = {"memmap": str(root / "mm"), "h5": str(root / "rec.h5"),
           "npy": str(root / "ev.npy")}
    package(jformats.memmap_packager(out["memmap"]), rec)
    package(jformats.hdf5_packager(out["h5"]), rec)
    xs, ys, ts, ps = rec[:4]
    np.save(out["npy"], np.stack([xs, ys, (ps > 0), ts * 1e6], 1))
    return out


def make(pkg, kind, path, method, device="cpu", **kw):
    cls = getattr(pkg, DATASETS[kind])
    kw = dict(voxel_method=dict(METHODS[method]), **kw)
    if kind == "npy":
        kw["sensor_resolution"] = SENSOR
    if pkg is ploaders:
        kw["device"] = device
    return cls(path, **kw)


def assert_voxel_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= VOXEL_REL * scale


def assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        if key == "voxel":
            assert_voxel_close(g, r)
        elif isinstance(r, list):
            assert len(g) == len(r)
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, r)


def compare_datasets(pd, jd, seeds=None):
    assert len(pd) == len(jd)
    assert pd.event_indices == jd.event_indices
    assert pd.sensor_resolution == jd.sensor_resolution
    if jd.has_frames:
        assert pd.frame_indices == jd.frame_indices
    for i in range(len(jd)):
        seed = None if seeds is None else seeds + i
        assert_items_equal(pd.__getitem__(i, seed=seed),
                           jd.__getitem__(i, seed=seed))


# ---------------------------------------------------------------------------
# Datasets: every reader x every windowing method
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("kind", list(DATASETS))
def test_dataset_matches_jax(paths, kind, method):
    kw = dict(return_events=True, return_prev_frame=True,
              return_prev_flow=True)
    if kind == "npy" and method == "between_frames":
        # no frames: a zero-length sequence in both packages
        with pytest.raises(ValueError):
            make(jloaders, kind, paths[kind], method, **kw)
        with pytest.raises(ConfigurationError):
            make(ploaders, kind, paths[kind], method, **kw)
        return
    with make(ploaders, kind, paths[kind], method, **kw) as pd, \
            make(jloaders, kind, paths[kind], method, **kw) as jd:
        compare_datasets(pd, jd)


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("temporal_bilinear", [True, False])
def test_voxel_options_match_jax(paths, combined, temporal_bilinear):
    kw = dict(combined_voxel_channels=combined,
              temporal_bilinear=temporal_bilinear)
    with make(ploaders, "memmap", paths["memmap"], "k_events", **kw) as pd, \
            make(jloaders, "memmap", paths["memmap"], "k_events",
                 **kw) as jd:
        for i in (0, len(jd) - 1):
            v = pd[i]["voxel"]
            assert v.shape[0] == (5 if combined else 10)
            assert_voxel_close(v, jd[i]["voxel"])


@pytest.mark.parametrize("transforms", [
    {"RandomCrop": {"size": 16}},
    {"CenterCrop": {"size": [20, 30]}},
    {"RobustNorm": {"low_perc": 5, "top_perc": 90},
     "RandomCrop": {"size": [16, 24]}},
])
def test_seeded_transforms_match_jax(paths, transforms):
    """The same per-item seed gives the same crop of voxel, frame and flow
    in both packages (the seeded module-level ``random``)."""
    kw = dict(transforms=transforms, return_prev_frame=True)
    with make(ploaders, "h5", paths["h5"], "between_frames", **kw) as pd, \
            make(jloaders, "h5", paths["h5"], "between_frames", **kw) as jd:
        compare_datasets(pd, jd, seeds=123)


def test_frame_after_the_last_event(tmp_path):
    """A ``between_frames`` recording whose last two frames come after its
    last event (the unused window past the last one starts at the end of
    the stream): the JAX package reads one event past the end and raises
    ``IndexError``; the port reads the last event (a documented
    divergence) and serves every window."""
    xs, ys, ts, ps, frame_ts, frames, flows = recording(8)
    frame_ts = np.concatenate([np.linspace(0.1, ts[-1] - 0.1,
                                           len(frames) - 2),
                               ts[-1] + np.array([0.01, 0.05])])
    path = str(tmp_path / "mm")
    package(jformats.memmap_packager(path),
            (xs, ys, ts, ps, frame_ts, frames, flows))
    with pytest.raises(IndexError):
        make(jloaders, "memmap", path, "between_frames")
    with make(ploaders, "memmap", path, "between_frames") as pd:
        assert len(pd) == len(frames) - 1
        assert pd.event_indices[-1][0] == pd.num_events
        for i in range(len(pd)):
            np.testing.assert_array_equal(pd[i]["frame"][0],
                                          frames[i] / np.float32(255.0))


def test_return_format_torch_keeps_the_grid_a_tensor(paths):
    with make(ploaders, "memmap", paths["memmap"], "k_events",
              return_format="torch", return_events=True) as pd, \
            make(ploaders, "memmap", paths["memmap"], "k_events",
                 return_events=True) as nd:
        item, ref = pd[1], nd[1]
        assert isinstance(item["voxel"], torch.Tensor)
        assert item["voxel"].device.type == "cpu"
        np.testing.assert_array_equal(item["voxel"].numpy(), ref["voxel"])
        # events relative to the window start, as the JAX "jax" format
        np.testing.assert_allclose(
            item["events"][:, 2],
            (ref["events"][:, 2] - float(ref["ts_idx0"])).astype(np.float32),
            atol=1e-6)
    with pytest.raises(ConfigurationError):
        make(ploaders, "memmap", paths["memmap"], "k_events",
             return_format="jax")


def test_dataset_without_a_device_needs_a_card(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(DeviceUnavailableError):
        make(ploaders, "memmap", paths["memmap"], "k_events", device=None)


def test_concat_dataset_matches_jax(paths):
    parts = [(make(ploaders, "memmap", paths["memmap"], m),
              make(jloaders, "memmap", paths["memmap"], m))
             for m in ("k_events", "fixed_frames")]
    pc = ploaders.ConcatDataset([p for p, _ in parts])
    jc = jloaders.ConcatDataset([j for _, j in parts])
    assert len(pc) == len(jc) and pc.cumulative_sizes == jc.cumulative_sizes
    for i in (0, len(jc) - 1, -1):
        assert_items_equal(pc[i], jc[i])


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------

def test_collate_functions_match_jax(paths):
    with make(jloaders, "h5", paths["h5"], "t_seconds",
              return_events=True) as jd:
        items = [jd[i] for i in range(3)]
    jb, pb = jloaders.BaseVoxelDataset, ploaders.BaseVoxelDataset
    for fn, kw in (("collate_fn", {}), ("collate_padded", {}),
                   ("collate_padded", {"capacity": 1000}),
                   ("collate_padded", {"bucket": False})):
        ref = getattr(jb, fn)(items, **kw)
        got = getattr(pb, fn)(items, **kw)
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], list):
                assert got[k] == ref[k]
            else:
                np.testing.assert_array_equal(got[k], ref[k])
    ragged = pb.collate_fn(items)
    got = ploaders.unpack_batched_events(ragged["events"],
                                         ragged["events_batch_indices"])
    ref = jloaders.unpack_batched_events(ragged["events"],
                                         ragged["events_batch_indices"])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# Readers and packagers
# ---------------------------------------------------------------------------

def test_memmap_packager_writes_the_jax_bytes(tmp_path):
    rec = recording(4)
    package(jformats.memmap_packager(str(tmp_path / "j")), rec)
    package(pformats.memmap_packager(str(tmp_path / "p")), rec)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p"))
    assert "index.npy" in names and "metadata.json" in names
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = {k: np.asarray(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype, obj[()], attrs)
            else:
                out[name] = attrs
        f.visititems(visit)
    return out


def test_hdf5_packager_writes_the_jax_datasets(tmp_path):
    rec = recording(5)
    package(jformats.hdf5_packager(str(tmp_path / "j.h5")), rec)
    package(pformats.hdf5_packager(str(tmp_path / "p.h5")), rec)
    ref, got = _h5_items(tmp_path / "j.h5"), _h5_items(tmp_path / "p.h5")
    assert list(got) == list(ref)
    for name, r in ref.items():
        g = got[name]
        if isinstance(r, tuple):
            assert g[0] == r[0], name
            np.testing.assert_array_equal(g[1], r[1])
            g, r = g[2], r[2]
        assert set(g) == set(r), name
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("reader", ["read_memmap_events_dict",
                                    "read_h5_events_dict",
                                    "read_npy_events"])
def test_readers_match_jax(paths, reader):
    path = paths[{"read_memmap_events_dict": "memmap",
                  "read_h5_events_dict": "h5",
                  "read_npy_events": "npy"}[reader]]
    got = getattr(pformats, reader)(path)
    ref = getattr(jformats, reader)(path)
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        got, ref = [got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)]
    for g, r in zip(got, ref):
        if isinstance(r, list):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, r)
    raw = pformats.read_memmap_events(paths["memmap"])
    np.testing.assert_array_equal(
        raw["index"], jformats.read_memmap_events(paths["memmap"])["index"])
    with open(os.path.join(paths["memmap"], "metadata.json")) as f:
        assert json.load(f)["index_layout"] == "start_end_v1"


def test_build_transform_registry():
    assert isinstance(ploaders.build_transform("CenterCrop", size=4),
                      ploaders.CenterCrop)
    with pytest.raises(RegistryError):
        ploaders.build_transform("Flip")
    x = np.random.default_rng(2).normal(size=(3, 10, 12)).astype(np.float32)
    for name, kw in (("RobustNorm", {}), ("CenterCrop", {"size": 6})):
        ref = jloaders.build_transform(name, **kw)(x)
        np.testing.assert_array_equal(
            ploaders.build_transform(name, **kw)(x), ref)
        np.testing.assert_allclose(
            ploaders.build_transform(name, **kw)(torch.as_tensor(x)).numpy(),
            ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The 'pallas' default: the Pallas image kernel against the CUDA flat
# kernel's plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_default():
    prev = jscatter.get_default_impl(), pscatter.get_default_impl()
    jscatter.set_default_impl("pallas")
    pscatter.set_default_impl("pallas")
    try:
        yield
    finally:
        jscatter.set_default_impl(prev[0])
        pscatter.set_default_impl(prev[1])


def test_voxel_grids_under_pallas_default_match(tmp_path, pallas_default):
    sensor = (64, 64)
    rec = recording(6, sensor=sensor, n=9000, duration=0.9, n_frames=4)
    path = str(tmp_path / "mm")
    package(jformats.memmap_packager(path), rec, sensor)
    cuda_scatter.reset_launch_counts()
    with ploaders.MemMapDataset(path, device="cpu") as pd, \
            jloaders.MemMapDataset(path) as jd:
        assert len(pd) == len(jd) == 3
        for i in range(len(jd)):
            n = np.diff(jd.event_indices[i])[0]
            assert 500 < n < 4000
            assert_voxel_close(pd[i]["voxel"], jd[i]["voxel"])
    # CPU tensors take the plain version: no kernel launched
    assert not any(cuda_scatter.launch_counts().values())
