"""Visualization: 3-D event/voxel/flow renderers and the visualizer registry
(port of ``event_utils_tpu.visualization``). matplotlib and mayavi are
imported only by the functions that draw; the arrays they draw are
computed on the device."""

from .draw_event_stream import (  # noqa: F401
    plot_between_frames,
    plot_events,
    plot_events_sliding,
    plot_voxel_grid,
)
from .draw_flow import (  # noqa: F401
    motion_compensate,
    plot_flow_and_events,
)
from .visualization_utils import (  # noqa: F401
    crop_to_size,
    ensure_dir,
    frame_stamps_to_start_end,
    get_frame_indices,
    parse_crop,
)
from .visualizers import (  # noqa: F401
    EventImageVisualizer,
    EventsVisualizer,
    TimeStampImageVisualizer,
    VISUALIZER_REGISTRY,
    Visualizer,
    VoxelImageVisualizer,
    VoxelVisualizer,
    get_visualizer,
)
from .draw_plane import draw_plane_figure  # noqa: F401
