"""Small helpers of the visualization renderers and CLIs
(reference lib/visualization/visualization_utils.py).

Port of ``event_utils_tpu.visualization.visualization_utils`` (a copy:
host-side Python)."""

from __future__ import annotations

import numpy as np

from ..errors import ConfigurationError
from ..utils.util import ensure_dir  # noqa: F401  (re-export)


def parse_crop(crop_str):
    """Parse an imagemagick-style ``WxH+X+Y`` crop string into
    ``[min_y, max_y, min_x, max_x]`` (reference visualization_utils.py:4-13)."""
    if crop_str is None:
        return None
    try:
        wh, xy = crop_str.split("+", 1)
        w, h = (int(v) for v in wh.split("x"))
        x, y = (int(v) for v in xy.split("+"))
    except Exception as exc:
        raise ConfigurationError(
            f"Invalid crop {crop_str!r}: expected WxH+X+Y") from exc
    return [y, y + h, x, x + w]


def crop_to_size(crop):
    """Height/width of a ``[min_y, max_y, min_x, max_x]`` crop
    (the reference's version returns negative sizes — catalogued bug,
    visualization_utils.py:14-15 — fixed here)."""
    return [crop[1] - crop[0], crop[3] - crop[2]]


def frame_stamps_to_start_end(frame_stamps):
    """Consecutive frame stamps -> per-interval (start, end) pairs
    (reference visualization_utils.py:22-28)."""
    frame_stamps = np.asarray(frame_stamps)
    return np.stack([frame_stamps[:-1], frame_stamps[1:]], axis=1)


def get_frame_indices(ts, frame_stamps):
    """Event index ranges bracketing each frame interval
    (reference visualization_utils.py:31-39)."""
    pairs = (frame_stamps if np.ndim(frame_stamps) == 2
             else frame_stamps_to_start_end(frame_stamps))
    starts = np.searchsorted(ts, pairs[:, 0])
    ends = np.searchsorted(ts, pairs[:, 1])
    return np.stack([starts, ends], axis=1)


def k_event_windows(n: int, k: int):
    """Fixed-count window index pairs ``(i, start, end)`` over an n-event
    stream (the k_events windowing of visualize_events/visualize_voxel)."""
    k = max(1, int(k))
    for i in range(max(1, (n + k - 1) // k)):
        s, e = i * k, min((i + 1) * k, n)
        if e <= s:
            return
        yield i, s, e
