"""Streaming window loaders on the native runtime (port of
``event_utils_tpu.data_loaders.native_loader``).

``NativeWindowedLoader`` goes straight from a memory-mapped event directory
to fixed-capacity padded batches with the C++ ingest runtime
(``event_utils_tpu_torch.native``): window tables and batch assembly run in
native threads, nothing is loaded until its window is touched, and the
output is the ``(B, capacity, 4)`` events plus mask layout that the
trainers and solvers consume. ``H5WindowedLoader`` does the same from an
HDF5 file with one contiguous slab read per batch, on a background reader;
``ChainLoader`` concatenates loaders over several recordings.

The loaders yield host numpy batches from a rotating pool of buffers;
``data_loaders.device_prefetch`` stages them into pinned memory and copies
them to the card. A failed build of the runtime raises
``NativeBuildError`` when a loader is made.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .. import native
from ..data_formats.read_events import read_memmap_events
from ..errors import ConfigurationError
from ..utils import profiling

# Rotating-pool depth: must cover every buffer alive at once — the reader's
# queue (2) + one being consumed + one being written.
_POOL_DEPTH = 4


def _out_buffers(pool: native.RotatingPool, B: int, capacity: int):
    return pool.get((B, capacity),
                    lambda: (np.zeros((B, capacity, 4), np.float32),
                             np.zeros((B, capacity), np.float32)))


def _window_table(method: str, num_events: int, ts, k: int,
                  sliding_window_w: int, t: float, sliding_window_t: float):
    """The (n, 2) window table; ``ts`` is called for the stamps only by the
    ``t_seconds`` method."""
    if method == "k_events":
        windows = native.k_event_windows(num_events, k, sliding_window_w)
    elif method == "t_seconds":
        windows = native.t_second_windows(ts(), t, sliding_window_t)
    else:
        raise ConfigurationError(f"Unknown window method {method!r}")
    if len(windows) == 0:
        raise ConfigurationError("Window parameters produce no windows")
    return windows


def _default_capacity(windows) -> int:
    """The longest window rounded up to a power of two."""
    longest = int((windows[:, 1] - windows[:, 0]).max())
    return int(2 ** np.ceil(np.log2(max(longest, 1))))


def _num_batches(num_windows: int, batch_size: int, drop_last: bool) -> int:
    if drop_last:
        return num_windows // batch_size
    return (num_windows + batch_size - 1) // batch_size


class NativeWindowedLoader:
    """Iterate padded event-window batches from an RPG-style memmap dir.

    @param memmap_path Memmap directory (``t.npy, xy.npy, p.npy``)
    @param method ``'k_events'`` or ``'t_seconds'``
    @param k / sliding_window_w Window size/overlap in events
    @param t / sliding_window_t Window size/overlap in seconds
    @param batch_size Windows per batch
    @param capacity Fixed event capacity per window (defaults to the max
        window length rounded up to a power of two)
    @param shuffle Shuffle window order each epoch (with ``rng``)
    @param relative_time Shift each window's timestamps to start at 0
        (keeps float32 precision on long recordings)

    Batches: ``events`` (B, capacity, 4) float32, ``events_mask`` (B,
    capacity), ``window_idx0`` / ``window_idx1`` (absolute event indices)
    and ``t_starts`` (absolute window-start stamps). A batch's arrays are
    reused after three more batches (copy to keep them longer).
    """

    def __init__(self, memmap_path: str, method: str = "k_events",
                 k: int = 20000, sliding_window_w: int = 0,
                 t: float = 0.05, sliding_window_t: float = 0.0,
                 batch_size: int = 8, capacity: Optional[int] = None,
                 shuffle: bool = False, relative_time: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 nthreads: int = 0, drop_last: bool = False):
        native.library()  # build (or load) now: a failure raises here
        data = read_memmap_events(memmap_path)
        self.t = data["t"]
        self.xy = data["xy"]
        self.p = data["p"]
        self.num_events = data["num_events"]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.relative_time = relative_time
        self.rng = rng or np.random.default_rng()
        self.nthreads = nthreads
        self.windows = _window_table(
            method, self.num_events, lambda: np.asarray(self.t).reshape(-1),
            k, sliding_window_w, t, sliding_window_t)
        self.capacity = (_default_capacity(self.windows) if capacity is None
                         else capacity)
        self.truncated_events = 0
        self._out_pool = native.RotatingPool(_POOL_DEPTH)

    def __len__(self):
        return _num_batches(len(self.windows), self.batch_size,
                            self.drop_last)

    def close(self):
        """Release the memmap views (the loaders' common contract; numpy
        memmaps close when collected)."""
        self.t = self.xy = self.p = None
        self._out_pool = native.RotatingPool(_POOL_DEPTH)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.windows))
        if self.shuffle:
            self.rng.shuffle(order)
        t_flat = np.asarray(self.t).reshape(-1)
        for s in range(0, len(order), self.batch_size):
            if self.drop_last and s + self.batch_size > len(order):
                return
            sel = self.windows[order[s:s + self.batch_size]]
            with profiling.span("loader.fill"):
                events, mask, trunc = native.fill_padded_batches(
                    self.t, self.xy, self.p, sel, self.capacity,
                    relative_time=self.relative_time, nthreads=self.nthreads,
                    out=_out_buffers(self._out_pool, len(sel),
                                     self.capacity))
            self.truncated_events += trunc
            yield {
                "events": events,
                "events_mask": mask,
                "window_idx0": sel[:, 0],
                "window_idx1": sel[:, 1],
                "t_starts": t_flat[np.clip(sel[:, 0], 0,
                                           self.num_events - 1)],
            }


class H5WindowedLoader:
    """Streaming padded-batch loader straight from an HDF5 event file
    (the Monash layout ``events/{xs,ys,ts,ps}``; polarity {0,1} ->
    {-1,+1}).

    Windows come from the on-disk stamps; each batch's events are read as
    ONE contiguous slab per component (sequential chunk access) and
    assembled by the native runtime. With ``prefetch`` a background thread
    reads slab k+1 while slab k is consumed; its errors reach the consumer,
    and an abandoned iteration stops and joins it before the next one
    starts. Same batch keys as ``NativeWindowedLoader`` (absolute indices
    and stamps); ``h5py`` is imported here only.
    """

    def __init__(self, h5_path: str, method: str = "k_events",
                 k: int = 20000, sliding_window_w: int = 0,
                 t: float = 0.05, sliding_window_t: float = 0.0,
                 batch_size: int = 8, capacity: Optional[int] = None,
                 relative_time: bool = True, nthreads: int = 0,
                 drop_last: bool = False, prefetch: bool = True):
        import h5py

        native.library()
        self._h5 = h5py.File(h5_path, "r")
        ev = self._h5["events"]
        self._xs, self._ys = ev["xs"], ev["ys"]
        self._ts, self._ps = ev["ts"], ev["ps"]
        self.num_events = len(self._ts)
        self.batch_size = batch_size
        self.relative_time = relative_time
        self.nthreads = nthreads
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.windows = _window_table(
            method, self.num_events,
            lambda: np.asarray(self._ts[:], np.float64), k, sliding_window_w,
            t, sliding_window_t)
        self.capacity = (_default_capacity(self.windows) if capacity is None
                         else capacity)
        self.truncated_events = 0
        self._out_pool = native.RotatingPool(_POOL_DEPTH)
        self._slab_pool = native.RotatingPool(_POOL_DEPTH)
        self._reader_stop = None
        self._reader_thread = None

    def __len__(self):
        return _num_batches(len(self.windows), self.batch_size,
                            self.drop_last)

    def _stop_reader(self):
        """Stop and JOIN the reader of an earlier iteration: it shares the
        rotating slab pool (and the file handle) with whatever comes next."""
        if self._reader_stop is not None:
            self._reader_stop.set()
            if self._reader_thread is not None and \
                    self._reader_thread.is_alive():
                self._reader_thread.join()

    def close(self):
        self._stop_reader()
        self._h5.close()

    def _slab_buffers(self, m):
        """Persistent slab read buffers (fresh ones would pay first-touch
        page faults per batch); the pool's depth covers the reader's queue,
        the slab being consumed and the one being read."""
        cap = 1 << max(int(np.ceil(np.log2(max(m, 1)))), 0)

        def make():
            return {
                "xs": np.zeros(cap, np.int32), "ys": np.zeros(cap, np.int32),
                "ts": np.zeros(cap, np.float64), "ps": np.zeros(cap, np.uint8),
                "raw_xs": np.zeros(cap, self._xs.dtype),
                "raw_ys": np.zeros(cap, self._ys.dtype),
                "raw_ps": np.zeros(cap, self._ps.dtype),
            }

        buf = self._slab_pool.get(cap, make)
        return {k: v[:m] for k, v in buf.items()}

    def _read_slab(self, sel):
        """One contiguous HDF5 read per component covering a window batch;
        the windows are made slab-relative for the native fill."""
        s = int(sel[:, 0].min())
        e = int(sel[:, 1].max())
        buf = self._slab_buffers(e - s)
        src = np.s_[s:e]
        self._xs.read_direct(buf["raw_xs"], src)
        self._ys.read_direct(buf["raw_ys"], src)
        self._ts.read_direct(buf["ts"], src)
        self._ps.read_direct(buf["raw_ps"], src)
        np.copyto(buf["xs"], buf["raw_xs"], casting="unsafe")
        np.copyto(buf["ys"], buf["raw_ys"], casting="unsafe")
        np.greater(buf["raw_ps"], 0, out=buf["ps"], casting="unsafe")
        return (buf["xs"], buf["ys"], buf["ts"], buf["ps"], sel - s, sel)

    def _prefetched(self, batches):
        """Slabs read ahead by a background thread (queue depth 2, within
        the slab pool's depth)."""
        self._stop_reader()
        stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=_POOL_DEPTH - 2)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                for sel in batches:
                    if stop.is_set() or not put(("ok",
                                                 self._read_slab(sel))):
                        return
                put(("done", None))
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                put(("err", exc))

        th = threading.Thread(target=reader, daemon=True)
        self._reader_stop, self._reader_thread = stop, th
        th.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "err":
                    raise item
                if kind == "done":
                    return
                yield item
        finally:
            stop.set()  # break, close or collection of the generator

    def __iter__(self) -> Iterator[dict]:
        batches = [self.windows[s:s + self.batch_size]
                   for s in range(0, len(self.windows), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        slabs = (self._prefetched(batches) if self.prefetch
                 else (self._read_slab(sel) for sel in batches))
        try:
            for xs, ys, ts, ps, rel_windows, abs_windows in slabs:
                events, mask, trunc = native.fill_padded_batches_components(
                    ts, xs, ys, ps, rel_windows, self.capacity,
                    relative_time=self.relative_time, nthreads=self.nthreads,
                    out=_out_buffers(self._out_pool, len(rel_windows),
                                     self.capacity))
                self.truncated_events += trunc
                yield {
                    "events": events,
                    "events_mask": mask,
                    "window_idx0": abs_windows[:, 0],
                    "window_idx1": abs_windows[:, 1],
                    "t_starts": ts[np.clip(rel_windows[:, 0], 0,
                                           len(ts) - 1)].copy(),
                }
        finally:
            slabs.close()  # an abandoned iteration halts its reader


class ChainLoader:
    """Several windowed loaders as one epoch stream (e.g. the recordings of
    ``cli.simulate --num_sequences``): every member's batches in turn, so
    windows never straddle recordings. Members should share ``capacity``
    so that consumers see one batch shape."""

    def __init__(self, loaders):
        self.loaders = list(loaders)
        if not self.loaders:
            raise ConfigurationError("ChainLoader needs at least one loader")

    def __len__(self):
        return sum(len(ld) for ld in self.loaders)

    def __iter__(self):
        for ld in self.loaders:
            yield from ld

    def close(self):
        for ld in self.loaders:
            if hasattr(ld, "close"):
                ld.close()

    @property
    def truncated_events(self):
        return sum(getattr(ld, "truncated_events", 0) for ld in self.loaders)
