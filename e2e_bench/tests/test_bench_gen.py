"""The frozen generator and memmap writer repeat for a seed."""

import json
import os

import numpy as np

import bench_util  # noqa: F401
from gen.memmap_writer import write_memmap_recording
from gen.recording import raw_events
from gen.rotating_stream import rotating_stream


def test_stream_repeats_for_a_seed_and_differs_across_seeds():
    a = rotating_stream(2**31 + 5, 50_000)
    b = rotating_stream(2**31 + 5, 50_000)
    c = rotating_stream(11, 50_000)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert not np.array_equal(a[0], c[0])
    xs, ys, ts, ps = a
    assert len(ts) == 50_000 and np.all(np.diff(ts) >= 0)
    assert xs.min() >= 0 and xs.max() < 240 and ys.min() >= 0
    assert ys.max() < 180 and set(np.unique(ps)) == {-1, 1}


def test_memmap_layout_repeats_and_reads_back(tmp_path):
    ev = rotating_stream(3, 20_000)
    digests = []
    for name in ("a", "b"):
        path = write_memmap_recording(str(tmp_path / name), *ev, (180, 240))
        assert np.load(os.path.join(path, "t.npy")).shape == (20_000, 1)
        assert np.load(os.path.join(path, "xy.npy")).dtype == np.int16
        assert np.load(os.path.join(path, "p.npy")).dtype == np.uint8
        with open(os.path.join(path, "metadata.json")) as f:
            assert json.load(f)["sensor_resolution"] == [180, 240]
        digests.append([open(os.path.join(path, n), "rb").read()
                        for n in ("t.npy", "xy.npy", "p.npy")])
        x, y, t, p = raw_events(path, 100, 200)
        np.testing.assert_array_equal(x, ev[0][100:200])
        np.testing.assert_array_equal(p, ev[3][100:200])
    assert digests[0] == digests[1]


def test_the_program_reads_the_recording_as_written(tmp_path):
    from event_utils_tpu_torch.data_loaders import NativeWindowedLoader
    ev = rotating_stream(4, 30_000)
    path = write_memmap_recording(str(tmp_path / "r"), *ev, (180, 240))
    loader = NativeWindowedLoader(path, method="k_events", k=10_000,
                                  batch_size=1, relative_time=False)
    batch = next(iter(loader))
    got = batch["events"][0][batch["events_mask"][0] != 0]
    np.testing.assert_array_equal(
        got, np.stack(raw_events(path, 0, 10_000), 1))
    loader.close()
