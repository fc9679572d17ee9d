"""Tracing and metrics utilities (port of
``event_utils_tpu.utils.profiling``): throughput meters, structured
logging, profiler traces.

Unlike the JAX package's, the meter and ``timed`` time the work and not its
dispatch: when CUDA is initialised they synchronise the card at the end of
the block. ``trace`` writes a ``torch.profiler`` Chrome trace and raises
when the profiler cannot start; it does not fall back to a wall clock.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import tempfile
import time
from typing import Optional

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
    directory). Yields the trace's path; it is written on exit."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "event_utils_tpu_torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        yield path
        _sync()
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
