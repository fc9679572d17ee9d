"""Dense event representations: event images, timestamp images, voxel grids,
RVT's stacked histograms."""

from .histogram import (  # noqa: F401
    histogram_shape,
    stacked_histogram,
    stacked_histogram_rows,
)
from .image import (  # noqa: F401
    EventImage,
    TimestampImage,
    events_to_image,
    events_to_image_drv,
    events_to_image_torch,
    events_to_timestamp_image,
    events_to_timestamp_image_torch,
    image_to_event_weights,
    interpolate_to_derivative_img,
    interpolate_to_image,
)
from .voxel_grid import (  # noqa: F401
    events_to_neg_pos_voxel,
    events_to_neg_pos_voxel_segments,
    events_to_neg_pos_voxel_torch,
    events_to_voxel,
    events_to_voxel_rows,
    events_to_voxel_segments,
    events_to_voxel_tiled,
    events_to_voxel_timesync,
    events_to_voxel_timesync_torch,
    events_to_voxel_torch,
    get_voxel_grid_as_image,
    plot_voxel_grid,
    segment_windows,
    voxel_grids_fixed_n,
    voxel_grids_fixed_n_torch,
    voxel_grids_fixed_t,
    voxel_grids_fixed_t_torch,
)
