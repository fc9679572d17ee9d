"""The native (C++) host-side ingest runtime, loaded through ctypes (port of
``event_utils_tpu.native``).

``libevio`` is the CPU runtime that keeps the card fed: binary search over
memory-mapped timestamp arrays, window index tables, multi-threaded
assembly of fixed-capacity padded event batches, and the counting-sort ROI
bucket fill. Its source is the port's own copy, ``csrc/evio.cpp``.

At first use, ``g++`` compiles it with the JAX package's flags into
``event_utils_tpu_torch/_build/<hash of the source, compiler, flags and
the host's -march=native target>/libevio.so`` (compiled to a temporary
file, then renamed into place, so processes that build at once are
safe). Nothing here falls back:
a failed build or load raises ``NativeBuildError``. The ``*_plain``
functions are straightforward numpy versions of the same functions; the
tests hold the library against them, and nothing on the path calls them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..errors import ConfigurationError, DataFormatError, NativeBuildError

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "evio.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_D = ctypes.c_double
SIGNATURES = {
    "evio_searchsorted_f64": ((_P, _L, _D, _I), _L),
    "evio_k_event_windows": ((_L, _L, _L, _P, _P, _L), _L),
    "evio_t_second_windows": ((_P, _L, _D, _D, _P, _P, _L), _L),
    "evio_fill_padded_batches": (
        (_P, _P, _P, _L, _P, _P, _L, _L, _I, _P, _P, _I), _L),
    "evio_fill_padded_batches_components": (
        (_P, _P, _P, _P, _L, _P, _P, _L, _L, _I, _P, _P, _I), _L),
    "evio_bucket_fill": (
        (_P, _P, _P, _P, _L, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P), _L),
}

_lock = threading.Lock()
_lib = None
# seconds spent compiling, from this process (empty when the build was cached)
build_log: dict = {}


@functools.lru_cache(maxsize=None)
def host_target(compiler: str = CXX) -> str:
    """What ``-march=native`` means on this host, as the compiler reports
    it (empty when the compiler cannot run; the build then raises)."""
    try:
        proc = subprocess.run([compiler, "-march=native", "-Q",
                               "--help=target"], capture_output=True,
                              text=True)
    except OSError:
        return ""
    return proc.stdout


def lib_path(compiler: str = CXX, build_dir=BUILD_DIR) -> Path:
    """Where the library built from the current source lands: the key
    hashes the source, the compiler, the flags and the host's target, so a
    ``-march=native`` library of another CPU is never loaded."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(
        (compiler,) + CXX_FLAGS).encode()
        + host_target(compiler).encode()).hexdigest()[:16]
    return Path(build_dir) / key / "libevio.so"


def build(compiler: str = CXX, build_dir=BUILD_DIR) -> ctypes.CDLL:
    """Compile ``csrc/evio.cpp`` (unless this source, compiler and flags
    were built before) and load it. Raises ``NativeBuildError`` with the
    compiler's output when either fails."""
    out = lib_path(compiler, build_dir)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [compiler, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                capture_output=True, text=True)
        except OSError as exc:
            raise NativeBuildError(
                f"libevio: cannot run the compiler {compiler!r}: {exc}"
            ) from exc
        if proc.returncode != 0:
            raise NativeBuildError(
                f"libevio: {compiler} failed (rc {proc.returncode}):\n"
                f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_log["seconds"] = time.perf_counter() - t0
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        raise NativeBuildError(f"libevio: cannot load {out}: {exc}") from exc
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = build()
    return _lib


def available() -> bool:
    """True when the library is loaded, or built for the current source
    (so that loading it compiles nothing)."""
    return _lib is not None or lib_path().exists()


def _ptr(arr: np.ndarray):
    return arr.ctypes.data


def _nthreads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else min(os.cpu_count() or 1, 16)


# ---------------------------------------------------------------------------
# Window tables
# ---------------------------------------------------------------------------

def searchsorted_f64(ts: np.ndarray, x: float, side: str = "left") -> int:
    """Binary search over a sorted float64 array (memmap-friendly: only the
    touched pages fault in)."""
    ts = np.ascontiguousarray(ts, np.float64)
    return int(library().evio_searchsorted_f64(
        _ptr(ts), len(ts), float(x), 0 if side == "left" else 1))


def searchsorted_f64_plain(ts, x: float, side: str = "left") -> int:
    return int(np.searchsorted(np.asarray(ts, np.float64), x, side=side))


def _check_stride(name: str, width, overlap, what: str):
    if overlap >= width:
        raise ConfigurationError(
            f"{name}: overlap ({overlap}) must be < {what} ({width}) — a "
            "non-positive stride never advances")


def k_event_windows(num_events: int, k: int, overlap: int = 0) -> np.ndarray:
    """(n, 2) fixed-count window index table: ``(i*stride, i*stride + k)``
    while the window fits."""
    _check_stride("k_event_windows", k, overlap, "k")
    max_windows = max(num_events // max(k - overlap, 1) + 1, 1)
    idx0 = np.empty(max_windows, np.int64)
    idx1 = np.empty(max_windows, np.int64)
    n = library().evio_k_event_windows(num_events, k, overlap, _ptr(idx0),
                                       _ptr(idx1), max_windows)
    return np.stack([idx0[:n], idx1[:n]], axis=1)


def k_event_windows_plain(num_events: int, k: int,
                          overlap: int = 0) -> np.ndarray:
    _check_stride("k_event_windows", k, overlap, "k")
    starts = np.arange(0, num_events - k + 1, k - overlap, dtype=np.int64)
    return np.stack([starts, starts + k], axis=1)


def _t_windows_max(ts, t_width, overlap) -> int:
    return int((ts[-1] - ts[0]) / max(t_width - overlap, 1e-12)) + 2


def t_second_windows(ts: np.ndarray, t_width: float,
                     overlap: float = 0.0) -> np.ndarray:
    """(n, 2) fixed-duration window index table over sorted timestamps:
    window starts at ``ts[0] + i*stride`` while ``start + t_width`` stays
    within the last stamp (plus 1e-12)."""
    _check_stride("t_second_windows", t_width, overlap, "t_width")
    ts = np.ascontiguousarray(ts, np.float64)
    if len(ts) == 0:
        return np.zeros((0, 2), np.int64)
    max_windows = _t_windows_max(ts, t_width, overlap)
    idx0 = np.empty(max_windows, np.int64)
    idx1 = np.empty(max_windows, np.int64)
    n = library().evio_t_second_windows(_ptr(ts), len(ts), float(t_width),
                                        float(overlap), _ptr(idx0),
                                        _ptr(idx1), max_windows)
    return np.stack([idx0[:n], idx1[:n]], axis=1)


def t_second_windows_plain(ts, t_width: float,
                           overlap: float = 0.0) -> np.ndarray:
    """The same table, the starts accumulated in double as the library
    does."""
    _check_stride("t_second_windows", t_width, overlap, "t_width")
    ts = np.asarray(ts, np.float64)
    if len(ts) == 0:
        return np.zeros((0, 2), np.int64)
    max_windows = _t_windows_max(ts, t_width, overlap)
    starts = []
    s = float(ts[0])
    while s + t_width <= float(ts[-1]) + 1e-12 and len(starts) < max_windows:
        starts.append(s)
        s += t_width - overlap
    starts = np.asarray(starts, np.float64)
    return np.stack([np.searchsorted(ts, starts),
                     np.searchsorted(ts, starts + t_width)],
                    axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# Padded batch assembly
# ---------------------------------------------------------------------------

def _out_pair(B: int, capacity: int, out):
    """The ``(events, mask)`` to fill: ``out`` after a shape check that
    guards the library's raw-pointer writes (a check that raises, so that
    ``python -O`` keeps it), else fresh arrays."""
    if out is None:
        return (np.empty((B, capacity, 4), np.float32),
                np.empty((B, capacity), np.float32))
    events, mask = out
    if (events.shape != (B, capacity, 4) or events.dtype != np.float32
            or mask.shape != (B, capacity) or mask.dtype != np.float32
            or not events.flags.c_contiguous
            or not mask.flags.c_contiguous):
        raise DataFormatError(
            f"out buffers must be contiguous float32 ({B}, {capacity}, 4) "
            f"and ({B}, {capacity}); got {events.shape}/{events.dtype}, "
            f"{mask.shape}/{mask.dtype}")
    return events, mask


def fill_padded_batches(t, xy, p, windows: np.ndarray, capacity: int,
                        relative_time: bool = True, nthreads: int = 0,
                        out=None):
    """Assemble ``(B, capacity, 4)`` float32 events ``(x, y, t, p)`` and
    ``(B, capacity)`` float32 masks from memmap'd components (t float64,
    xy int16 (n, 2), p uint8) for a ``(B, 2)`` window table.

    Polarity {0, 1} -> {-1, +1}; timestamps window-relative when
    ``relative_time``; windows are clamped to ``[0, n)`` (an inverted one
    is all padding); padding repeats the last stamp with mask 0. Returns
    ``(events, mask, truncated_events)``. ``out``: an ``(events, mask)``
    pair to fill in place (steady-state loaders rotate persistent buffers:
    fresh ones pay the first-touch page faults on every call).
    """
    windows = np.ascontiguousarray(windows, np.int64).reshape(-1, 2)
    B = len(windows)
    events, mask = _out_pair(B, capacity, out)
    t = np.ascontiguousarray(np.asarray(t).reshape(-1), np.float64)
    xy = np.ascontiguousarray(np.asarray(xy).reshape(len(t), -1), np.int16)
    p = np.ascontiguousarray(np.asarray(p).reshape(-1), np.uint8)
    if xy.shape[1] != 2 or len(p) != len(t):
        raise DataFormatError(f"t {t.shape}, xy {xy.shape} and p {p.shape} "
                              "must describe the same events")
    idx0 = np.ascontiguousarray(windows[:, 0])
    idx1 = np.ascontiguousarray(windows[:, 1])
    truncated = library().evio_fill_padded_batches(
        _ptr(t), _ptr(xy), _ptr(p), len(t), _ptr(idx0), _ptr(idx1), B,
        capacity, 1 if relative_time else 0, _ptr(events), _ptr(mask),
        _nthreads(nthreads))
    return events, mask, int(truncated)


def fill_padded_batches_components(t, xs, ys, p, windows: np.ndarray,
                                   capacity: int, relative_time: bool = True,
                                   nthreads: int = 0, out=None):
    """:func:`fill_padded_batches` over separate ``xs``/``ys`` arrays (the
    HDF5 layout; any integer type, converted to int32). Same contract;
    ``windows`` index the given arrays (slab readers pass slab-relative
    windows)."""
    windows = np.ascontiguousarray(windows, np.int64).reshape(-1, 2)
    B = len(windows)
    events, mask = _out_pair(B, capacity, out)
    t = np.ascontiguousarray(np.asarray(t).reshape(-1), np.float64)
    xs = np.ascontiguousarray(np.asarray(xs).reshape(-1), np.int32)
    ys = np.ascontiguousarray(np.asarray(ys).reshape(-1), np.int32)
    p = np.ascontiguousarray(np.asarray(p).reshape(-1), np.uint8)
    if not len(xs) == len(ys) == len(p) == len(t):
        raise DataFormatError(f"t {t.shape}, xs {xs.shape}, ys {ys.shape} "
                              f"and p {p.shape} must have one length")
    idx0 = np.ascontiguousarray(windows[:, 0])
    idx1 = np.ascontiguousarray(windows[:, 1])
    truncated = library().evio_fill_padded_batches_components(
        _ptr(t), _ptr(xs), _ptr(ys), _ptr(p), len(t), _ptr(idx0),
        _ptr(idx1), B, capacity, 1 if relative_time else 0, _ptr(events),
        _ptr(mask), _nthreads(nthreads))
    return events, mask, int(truncated)


def fill_padded_batches_components_plain(t, xs, ys, p, windows, capacity,
                                         relative_time: bool = True):
    """numpy version of both fills (``xy`` callers pass its columns)."""
    windows = np.asarray(windows, np.int64).reshape(-1, 2)
    t = np.asarray(t, np.float64).reshape(-1)
    xs, ys = (np.asarray(a).reshape(-1).astype(np.int32) for a in (xs, ys))
    p = np.asarray(p).reshape(-1)
    events = np.zeros((len(windows), capacity, 4), np.float32)
    mask = np.zeros((len(windows), capacity), np.float32)
    truncated = 0
    for w, (s, e) in enumerate(windows):
        s, e = max(int(s), 0), min(int(e), len(t))
        cnt = max(min(e - s, capacity), 0)
        truncated += max(e - s - capacity, 0)
        tb = t[s] if (relative_time and cnt) else 0.0
        events[w, :cnt, 0] = xs[s:s + cnt]
        events[w, :cnt, 1] = ys[s:s + cnt]
        events[w, :cnt, 2] = t[s:s + cnt] - tb
        events[w, :cnt, 3] = np.where(p[s:s + cnt] > 0, 1.0, -1.0)
        mask[w, :cnt] = 1.0
        events[w, cnt:, 2] = events[w, cnt - 1, 2] if cnt else 0.0
    return events, mask, truncated


def fill_padded_batches_plain(t, xy, p, windows, capacity,
                              relative_time: bool = True):
    xy = np.asarray(xy).reshape(-1, 2)
    return fill_padded_batches_components_plain(
        t, xy[:, 0], xy[:, 1], p, windows, capacity, relative_time)


class RotatingPool:
    """Pre-faulted buffer sets reused round-robin (fresh allocations pay
    first-touch page faults on every call).

    Contract: a buffer handed out stays valid until ``depth - 1`` further
    ``get`` calls with the same key; consumers that keep a result longer
    copy it (``data_loaders.device_prefetch`` stages every batch at once).
    """

    def __init__(self, depth: int = 4):
        self.depth = depth
        self._pools: dict = {}
        self._idx: dict = {}
        self._lock = threading.Lock()

    def get(self, key, make):
        with self._lock:
            pool = self._pools.setdefault(key, [])
            if len(pool) < self.depth:
                pool.append(make())
                self._idx[key] = len(pool) - 1
                return pool[-1]
            self._idx[key] = (self._idx[key] + 1) % self.depth
            return pool[self._idx[key]]


# ---------------------------------------------------------------------------
# ROI bucketing
# ---------------------------------------------------------------------------

_bucket_pool = RotatingPool(depth=2)


def bucket_fill(xs, ys, ts, ps, roi_size, grid_shape, capacity: int):
    """Counting-sort bucket fill: ``(R, capacity)`` float32 per-bucket
    arrays and mask in one O(n) pass, R = ny * nx row-major buckets of
    ``roi_size`` (coordinates clamped to the grid), time order kept within
    each bucket, events past a bucket's capacity dropped. Returns ``(bx,
    by, bt, bp, bmask, truncated)``; the arrays rotate through a pool of
    two per shape, so a result stays valid until the next call of the same
    shape (copy it to keep it)."""
    rh, rw = roi_size
    ny, nx = grid_shape
    R = ny * nx
    xs, ys, ts, ps = (np.ascontiguousarray(np.asarray(a).reshape(-1),
                                           np.float64)
                      for a in (xs, ys, ts, ps))
    if not len(xs) == len(ys) == len(ts) == len(ps):
        raise DataFormatError("bucket_fill: xs, ys, ts and ps must have one "
                              "length")
    bx, by, bt, bp, bmask = _bucket_pool.get(
        (R, capacity),
        lambda: tuple(np.zeros((R, capacity), np.float32) for _ in range(5)))
    truncated = library().evio_bucket_fill(
        _ptr(xs), _ptr(ys), _ptr(ts), _ptr(ps), len(xs), rh, rw, ny, nx,
        capacity, _ptr(bx), _ptr(by), _ptr(bt), _ptr(bp), _ptr(bmask))
    return bx, by, bt, bp, bmask, int(truncated)


def bucket_fill_plain(xs, ys, ts, ps, roi_size, grid_shape, capacity: int):
    rh, rw = roi_size
    ny, nx = grid_shape
    R = ny * nx
    xs, ys, ts, ps = (np.asarray(a, np.float64).reshape(-1)
                      for a in (xs, ys, ts, ps))
    # C's (int) truncates toward zero; negatives clamp to 0 either way
    iy = np.clip(np.trunc(ys).astype(np.int64) // rh, 0, ny - 1)
    ix = np.clip(np.trunc(xs).astype(np.int64) // rw, 0, nx - 1)
    rid = iy * nx + ix
    order = np.argsort(rid, kind="stable")
    counts = np.bincount(rid, minlength=R)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(len(rid), np.int64)
    pos[order] = np.arange(len(rid)) - starts[rid[order]]
    keep = pos < capacity
    flat = rid[keep] * capacity + pos[keep]
    out = []
    for a in (xs, ys, ts, ps, np.ones(len(xs))):
        b = np.zeros(R * capacity, np.float32)
        b[flat] = a[keep]
        out.append(b.reshape(R, capacity))
    return (*out, int((~keep).sum()))
