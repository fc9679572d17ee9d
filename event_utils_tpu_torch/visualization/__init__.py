"""Visualization: 3-D event-cloud and voxel renders (matplotlib, imported
inside the functions that draw) and their crop helpers. Port of the part of
``event_utils_tpu.visualization`` that ``augment_demo`` draws with; the
flow and plane renderers and the visualizer registry are not ported yet
(``ROADMAP.md`` queue 1)."""

from .draw_event_stream import (  # noqa: F401
    plot_between_frames,
    plot_events,
    plot_events_sliding,
    plot_voxel_grid,
)
from .visualization_utils import crop_to_size, parse_crop  # noqa: F401
