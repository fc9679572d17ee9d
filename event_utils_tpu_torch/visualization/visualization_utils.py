"""Crop helpers of the visualization renderers
(reference lib/visualization/visualization_utils.py).

Port of the part of ``event_utils_tpu.visualization.visualization_utils``
that ``draw_event_stream`` uses (a copy: host-side Python)."""

from __future__ import annotations

from ..errors import ConfigurationError


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
