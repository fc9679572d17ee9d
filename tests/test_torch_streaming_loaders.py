"""The port's streaming loaders, ``EventDataLoader``, ``device_prefetch``
and ``utils.profiling`` against the JAX package's, on the CPU.

Batches are held to JAX's exactly (the same native fill of the same
windows): memmap and HDF5 recordings, ``k_events`` and ``t_seconds``
windows, shuffled with equally seeded generators, with and without the
background slab reader. The contracts of ``tests/test_native.py`` and
``tests/test_data_loaders.py`` are mirrored: a slow consumer gets
uncorrupted batches, reader and producer errors reach the consumer, an
abandoned iteration stops its reader, window indices and stamps are
absolute. ``device_prefetch`` on the CPU yields tensors equal to the host
batches (copies, so the loaders' rotating buffers may be reused).
``ThroughputMeter`` runs on the same fake clock as JAX's and gives the
same rates (1e-12 relative).
"""

import json
import logging
import time

import h5py
import numpy as np
import pytest
import torch

from event_utils_tpu.data_loaders import native_loader as jnl
from event_utils_tpu.data_loaders import prefetch as jpf
from event_utils_tpu.utils import profiling as jprof
from event_utils_tpu_torch.data_loaders import (ChainLoader,
                                                EventDataLoader,
                                                H5WindowedLoader,
                                                NativeWindowedLoader,
                                                device_prefetch)
from event_utils_tpu_torch.data_loaders.prefetch import _default_collate
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DeviceUnavailableError)
from event_utils_tpu_torch.utils import profiling

KEYS = ("events", "events_mask", "window_idx0", "window_idx1", "t_starts")


def write_recording(tmp_path, seed, n, name="rec", H=48, W=64, t_max=1.0):
    """The same events as an HDF5 file and a memmap directory."""
    g = np.random.default_rng(seed)
    t = np.sort(g.uniform(0, t_max, n))
    xs = g.integers(0, W, n).astype(np.int16)
    ys = g.integers(0, H, n).astype(np.int16)
    p = g.integers(0, 2, n).astype(np.uint8)
    h5 = str(tmp_path / f"{name}.h5")
    with h5py.File(h5, "w") as f:
        ev = f.create_group("events")
        ev.create_dataset("xs", data=xs)
        ev.create_dataset("ys", data=ys)
        ev.create_dataset("ts", data=t)
        ev.create_dataset("ps", data=p.astype(bool))
        f.attrs["sensor_resolution"] = (H, W)
    mm = tmp_path / f"{name}_mm"
    mm.mkdir()
    np.save(mm / "t.npy", t[:, None])
    np.save(mm / "xy.npy", np.stack([xs, ys], axis=1))
    np.save(mm / "p.npy", p[:, None])
    return h5, str(mm), t


def copies(loader):
    return [{k: np.array(b[k]) for k in KEYS} for b in loader]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return write_recording(tmp_path_factory.mktemp("rec"), 0, 30000)


@pytest.mark.parametrize("kw", [
    dict(method="k_events", k=2000, batch_size=4),
    dict(method="k_events", k=1500, sliding_window_w=500, batch_size=3,
         capacity=1024, drop_last=True),
    dict(method="t_seconds", t=0.1, sliding_window_t=0.04, batch_size=2,
         relative_time=False),
])
def test_memmap_loader_matches_jax(rec, kw):
    _, mm, _ = rec
    got = NativeWindowedLoader(mm, **kw)
    want = jnl.NativeWindowedLoader(mm, **kw)
    assert len(got) == len(want) and got.capacity == want.capacity
    assert_batches_equal(copies(got), copies(want))
    assert got.truncated_events == want.truncated_events
    if "capacity" in kw:
        assert got.truncated_events > 0


def test_memmap_loader_shuffles_like_jax(rec):
    _, mm, _ = rec
    kw = dict(k=1000, batch_size=5, shuffle=True)
    got = NativeWindowedLoader(mm, rng=np.random.default_rng(3), **kw)
    want = jnl.NativeWindowedLoader(mm, rng=np.random.default_rng(3), **kw)
    for _ in range(2):  # two epochs: the generators advance alike
        assert_batches_equal(copies(got), copies(want))


@pytest.mark.parametrize("kw", [
    dict(method="k_events", k=2000, batch_size=4, capacity=2048),
    dict(method="k_events", k=3000, batch_size=3, prefetch=False,
         drop_last=True),
    dict(method="t_seconds", t=0.1, batch_size=2, relative_time=False),
])
def test_h5_loader_matches_jax_and_the_memmap_loader(rec, kw):
    h5, mm, _ = rec
    got = H5WindowedLoader(h5, **kw)
    want = jnl.H5WindowedLoader(h5, **kw)
    try:
        assert len(got) == len(want)
        batches = copies(got)
        assert_batches_equal(batches, copies(want))
    finally:
        got.close()
        want.close()
    mkw = {k: v for k, v in kw.items() if k != "prefetch"}
    assert_batches_equal(batches, copies(NativeWindowedLoader(mm, **mkw)))


def test_h5_prefetch_slow_consumer_no_corruption(rec):
    h5, _, _ = rec
    kw = dict(method="k_events", k=700, batch_size=2, capacity=1024)
    ref = H5WindowedLoader(h5, prefetch=False, **kw)
    want = copies(ref)
    ref.close()
    ld = H5WindowedLoader(h5, prefetch=True, **kw)
    got = []
    for b in ld:
        time.sleep(0.002)  # slow consumer: the reader runs far ahead
        got.append({k: np.array(b[k]) for k in KEYS})
    ld.close()
    assert_batches_equal(got, want)


def test_h5_prefetch_reader_errors_reach_the_consumer(rec):
    h5, _, _ = rec
    ld = H5WindowedLoader(h5, method="k_events", k=1000, batch_size=2,
                          capacity=1024)
    it = iter(ld)
    next(it)
    ld._h5.close()  # the file goes away under the reader
    with pytest.raises(Exception):
        for _ in it:
            pass


def test_h5_abandoned_iteration_stops_its_reader(rec):
    h5, _, _ = rec
    ld = H5WindowedLoader(h5, method="k_events", k=500, batch_size=2,
                          prefetch=True)
    full = copies(ld)
    it = iter(ld)
    next(it)
    del it  # abandoned after one batch
    time.sleep(0.2)
    assert ld._reader_stop is not None and ld._reader_stop.is_set()
    assert_batches_equal(copies(ld), full)
    ld.close()
    assert not ld._reader_thread.is_alive()


def test_h5_window_indices_and_stamps_are_absolute(rec):
    h5, _, t = rec
    ld = H5WindowedLoader(h5, method="k_events", k=500, batch_size=2,
                          prefetch=False)
    start = 0
    for b in ld:
        for i0, i1 in zip(b["window_idx0"], b["window_idx1"]):
            assert (i0, i1) == (start, start + 500)
            start += 500
        np.testing.assert_array_equal(b["t_starts"],
                                      t[np.asarray(b["window_idx0"])])
    ld.close()
    assert start == 30000


def test_chain_loader_matches_jax(tmp_path):
    recs = [write_recording(tmp_path, s, 9000 + 1000 * s, name=f"r{s}")[0]
            for s in range(3)]
    kw = dict(method="k_events", k=2000, batch_size=2, capacity=2048)
    got = ChainLoader([H5WindowedLoader(p, **kw) for p in recs])
    want = jnl.ChainLoader([jnl.H5WindowedLoader(p, **kw) for p in recs])
    assert len(got) == len(want) == sum(len(ld) for ld in got.loaders)
    assert_batches_equal(copies(got), copies(want))
    assert got.truncated_events == want.truncated_events == 0
    got.close()
    want.close()
    with pytest.raises(ConfigurationError):
        ChainLoader([])


class Items:
    """A sequence-protocol dataset of small item dicts; item ``bad``
    raises."""

    def __init__(self, n, bad=None, as_tensor=False):
        self.n, self.bad, self.as_tensor = n, bad, as_tensor

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError("corrupt window")
        x = np.arange(3, dtype=np.float32) + i
        return {"x": torch.as_tensor(x) if self.as_tensor else x,
                "idx": i, "name": f"w{i}"}


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_event_data_loader_matches_jax(workers, drop_last):
    kw = dict(batch_size=3, shuffle=True, num_workers=workers,
              drop_last=drop_last)
    got = list(EventDataLoader(Items(10), rng=np.random.default_rng(1), **kw))
    want = list(jpf.EventDataLoader(Items(10), rng=np.random.default_rng(1),
                                    **kw))
    assert len(got) == len(want) == (3 if drop_last else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["idx"], w["idx"])
        np.testing.assert_array_equal(g["name"], w["name"])


def test_default_collate_stacks_tensors_with_torch():
    items = [Items(4, as_tensor=True)[i] for i in range(4)]
    out = _default_collate(items)
    assert isinstance(out["x"], torch.Tensor) and out["x"].shape == (4, 3)
    assert isinstance(out["idx"], np.ndarray)
    np.testing.assert_array_equal(out["name"], ["w0", "w1", "w2", "w3"])


def test_event_data_loader_errors_reach_the_consumer():
    with pytest.raises(RuntimeError, match="corrupt window"):
        list(EventDataLoader(Items(8, bad=5), batch_size=2, num_workers=1))
    # abandoning mid-epoch neither hangs nor leaves a producer blocked
    ld = EventDataLoader(Items(8, bad=5), batch_size=1, num_workers=2,
                         queue_depth=1)
    for _ in ld:
        break


def test_device_prefetch_on_the_cpu_copies_every_batch(rec):
    _, mm, _ = rec
    kw = dict(k=1000, batch_size=2)
    want = copies(NativeWindowedLoader(mm, **kw))
    # depth 6 > the loader's pool of 4: every batch must be a copy
    got = list(device_prefetch(NativeWindowedLoader(mm, **kw),
                               prefetch_depth=6, device="cpu"))
    # JAX's arrays may alias the loader's rotating buffers on the CPU:
    # copied as they come
    jgot = [{k: np.array(b[k]) for k in KEYS} for b in jpf.device_prefetch(
        jnl.NativeWindowedLoader(mm, **kw), prefetch_depth=2)]
    assert len(got) == len(want) == len(jgot)
    for g, w, j in zip(got, want, jgot):
        for k in KEYS:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
            # JAX keeps f32 without x64: its t_starts are the f32 stamps
            jk = np.asarray(j[k])
            np.testing.assert_array_equal(g[k].numpy().astype(jk.dtype), jk)
    only = next(device_prefetch(iter(want), device="cpu",
                                keys=("events",)))
    assert isinstance(only["events"], torch.Tensor)
    assert isinstance(only["events_mask"], np.ndarray)


def test_device_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        next(device_prefetch(iter([{"x": np.zeros(3)}])))


def test_throughput_meter_arithmetic_matches_jax(monkeypatch):
    # both modules read time.perf_counter: each meter runs on its own pass
    # over the same ticks
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.1, 5.0, 5.0]
    port, jax_meter = profiling.ThroughputMeter("v"), jprof.ThroughputMeter(
        "v")
    calls = [(1_000_000,), (300_000,), (2_000_000,), (7,)]
    for meter in (port, jax_meter):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for (n,) in calls:
            with meter.measure(num_events=n):
                pass
    monkeypatch.undo()
    for attr in ("rate", "total_events", "total_seconds", "rate_mevs"):
        a, b = getattr(port, attr), getattr(jax_meter, attr)
        assert abs(a - b) <= 1e-12 * abs(b), (attr, a, b)
    assert repr(port) == repr(jax_meter)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_log_metrics_and_timed_log_like_jax():
    got, want = Lines(), Lines()
    profiling.logger.addHandler(got)
    jprof.logger.addHandler(want)
    try:
        for mod in (profiling, jprof):
            mod.log_metrics(step=3, loss=np.float32(0.25),
                            rates=np.arange(3), name="x")
            with mod.timed("block"):
                pass
    finally:
        profiling.logger.removeHandler(got)
        jprof.logger.removeHandler(want)
    assert profiling.logger.name == "event_utils_tpu_torch"
    assert got.lines[0] == want.lines[0]
    assert json.loads(got.lines[0][len("metrics "):])["rates"] == [0, 1, 2]
    assert got.lines[1].startswith("block: ") and got.lines[1].endswith(" s")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
