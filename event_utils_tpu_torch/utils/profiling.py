"""Tracing and metrics utilities (port of
``event_utils_tpu.utils.profiling``): throughput meters, structured
logging, profiler traces, and the program's own spans and counters.

Unlike the JAX package's, the meter and ``timed`` time the work and not its
dispatch: when CUDA is initialised they synchronise the card at the end of
the block. ``trace`` writes a ``torch.profiler`` Chrome trace and raises
when the profiler cannot start; it does not fall back to a wall clock.

Spans and counters (``span``, ``spanned``, ``count``, ``take``) mark where
the program's layers start and end, and what they move, from inside the
program. They are off by default: ``span(name)`` then returns one shared
no-op context manager, or only the profiler mark below while a
``torch.profiler`` runs, and ``count`` returns at once. Turned on
(``enable_spans``, or inside ``trace``), a span records its name, its start
and end (``time.perf_counter``) and its parent, the span open around it on
the same thread; a counter adds integers under a name. Both are kept in
memory until ``take`` hands them over and clears them, once a request (a
window). A span times the host's issue of the work: it never synchronises
the card, reads a tensor back or allocates on the device. While a
``torch.profiler`` runs, each span, on or off, is also a
``record_function`` named ``span:<name>`` on the profiler's clock, beside
the card's activity: any profile of the program names its layers, and
what it waits for, without the registry.

Names in use: spans ``cmax.solve`` (``grid_cmax_batched``), ``cmax.bucket``
(the host ROI bucketing and the batches' copies to the device),
``cmax.grid_search``, ``cmax.descent`` (the GD or BFGS refine),
``cmax.grad`` (each autograd backward of the refine; absent where the GD
refine replays a CUDA graph), ``loader.fill`` (``NativeWindowedLoader``'s
batch fill), ``reconstruct.fetch`` (``cli/reconstruct.py``'s per-chunk
window fetch: dataset items, one batched build of their voxel grids,
stack, padding, one copy back, or none where the grids go to the card),
``e2vid.forward`` (each window's forward pass in
``ReconstructionTrainer.reconstruct``), ``eraft.encode`` (E-RAFT's
feature encoder on both grids and its context encoder),
``eraft.corr`` (the correlation volume and its pyramid), ``eraft.refine``
(the refinements: lookups, update block, flow updates) and
``eraft.upsample`` (the convex x8 upsampling, ``models.eraft.ERAFT``),
``rvt.attn`` (RVT's block- and grid-SA: each partition's norm, attention
and residual, every stage), ``rvt.mlp`` (their MLPs), ``rvt.lstm`` (the
stages' ConvLSTMs), ``rvt.neck`` (the PAFPN) and ``rvt.head`` (the YOLOX
head, ``models.rvt.RVT``: its eager forward pass), ``rvt.replay`` (a window
replayed from ``RVT.step``'s CUDA graph);
counters ``cmax.h2d_bytes`` (bytes
the solvers copy from host arrays to the device), ``cmax.graph_captures``
and ``cmax.graph_replays`` (the GD refine's CUDA graphs captured and
replayed), ``e2vid.windows`` (windows through the reconstruction network),
``reconstruct.h2d_bytes`` (the voxel chunk's bytes copied to the card),
``reconstruct.batched_windows`` (windows whose grids the chunk fetch built
in one batched call), ``reconstruct.card_windows`` (those of them handed
over on the card with no copy to the host: ``ChunkFetch.on``'s streaming
branch), ``eraft.pairs`` (pairs of grids through E-RAFT),
``eraft.iterations`` (its refinements, ``iters`` a pair), ``rvt.windows``
(windows through RVT), ``rvt.resets`` (those that started from the
zero state) and ``rvt.graph_captures`` (RVT steps captured as CUDA
graphs).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import logging
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

from .util import format_power

logger = logging.getLogger("event_utils_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    # this handler owns the output: an app that configures root logging
    # would otherwise see every line twice
    logger.propagate = False


def _json_default(obj):
    """Best-effort serializer: metrics logging must never crash the loop."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    try:
        return float(obj)
    except (TypeError, ValueError):
        return str(obj)


def log_metrics(**metrics):
    """Emit one structured (JSON) metrics line."""
    logger.info("metrics %s", json.dumps(metrics, default=_json_default))


def _sync():
    """Wait for the card's queued work, when this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ThroughputMeter:
    """Events-per-second meter with exponential smoothing.

    >>> meter = ThroughputMeter("voxelize")
    >>> with meter.measure(num_events=len(xs)):
    ...     events_to_voxel(...)
    >>> meter.rate_mevs

    The block's time ends when the card has finished its work.
    """

    def __init__(self, name: str = "", alpha: float = 0.3):
        self.name = name
        self.alpha = alpha
        self.rate = 0.0  # events / second
        self.total_events = 0
        self.total_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, num_events: int):
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        inst = num_events / max(dt, 1e-12)
        self.rate = inst if self.rate == 0 else (
            self.alpha * inst + (1 - self.alpha) * self.rate)
        self.total_events += num_events
        self.total_seconds += dt

    @property
    def rate_mevs(self) -> float:
        return self.rate / 1e6

    def __repr__(self):
        val, unit = format_power(self.rate)
        return f"ThroughputMeter({self.name}: {val:.1f} {unit}ev/s)"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (host, and the card when
    there is one) and write a Chrome trace, ``trace.json``, into
    ``log_dir`` (default: ``event_utils_tpu_torch-trace`` in the temporary
    directory). Yields the trace's path; it is written on exit. The
    program's spans are on for the block (``span:<name>`` in the trace,
    over the kernels they issued) and kept for ``take``; the earlier state
    comes back on exit."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "event_utils_tpu_torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    was_on = enable_spans(True)
    try:
        with profile(activities=activities) as prof:
            yield path
            _sync()
    finally:
        enable_spans(was_on)
    prof.export_chrome_trace(path)
    logger.info("trace written to %s; traced block took %.3f s", path,
                time.perf_counter() - t0)


@contextlib.contextmanager
def timed(label: str):
    """Log the wall clock of a block, the card's work included."""
    t0 = time.perf_counter()
    yield
    _sync()
    logger.info("%s: %.3f s", label, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------

# One registry for the process: the spans sit deep inside the solvers, which
# no caller passes a recorder to. Tests and callers restore the state that
# ``enable_spans`` returns.
_spans_on = False
_lock = threading.Lock()
_local = threading.local()   # each thread's stack of open spans
_done: List["Span"] = []
_counts: Dict[str, int] = {}

Taken = collections.namedtuple("Taken", "request spans counts")
Taken.__doc__ = ("What ``take`` hands over: the caller's ``request`` id, the "
                 "spans closed since the last take (by start) and the "
                 "counter totals.")

_OFF = contextlib.nullcontext()   # the one no-op span of the off state


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One timed block: ``name``, ``start`` and ``end`` in
    ``time.perf_counter`` seconds, and ``parent``, the span open around it
    on the same thread (None at the top). Inside an open span of its own
    name it times nothing: the outermost one holds the time, so per-name
    totals count no time twice."""

    __slots__ = ("name", "start", "end", "parent", "_mark")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = self.parent = self._mark = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        stack = _stack()
        if any(s.name == self.name for s in stack):
            return self
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._mark = torch.profiler.record_function("span:" + self.name)
            self._mark.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.start is None:
            return False
        self.end = time.perf_counter()
        if self._mark is not None:
            self._mark.__exit__(*exc)
            self._mark = None
        _stack().pop()
        with _lock:
            _done.append(self)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` when
    spans are on. Off, it is the shared no-op one, or under a running
    profiler the ``span:<name>`` mark alone."""
    if not _spans_on:
        if torch.autograd._profiler_enabled():
            return torch.profiler.record_function("span:" + name)
        return _OFF
    return Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` when spans are on."""
    if not _spans_on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def enable_spans(on: bool = True) -> bool:
    """Turn the program's spans and counters on or off; returns the earlier
    state, for the caller to restore."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def spans_enabled() -> bool:
    """Whether spans and counters record now."""
    return _spans_on


def take(request=None) -> Taken:
    """The spans closed and the counts added since the last take (every
    thread's), under the caller's ``request`` id; clears them."""
    global _done, _counts
    with _lock:
        spans, counts = _done, _counts
        _done, _counts = [], {}
    return Taken(request, sorted(spans, key=lambda s: s.start), counts)


def totals(spans) -> Dict[str, float]:
    """Seconds in each span name."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def self_times(spans) -> Dict[str, float]:
    """Self seconds of each span name: its spans' durations less what their
    child spans (among ``spans``) cover."""
    out = totals(spans)
    present = {id(s) for s in spans}
    for s in spans:
        if s.parent is not None and id(s.parent) in present:
            out[s.parent.name] -= s.seconds
    return out
