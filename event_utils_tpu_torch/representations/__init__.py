"""Dense event representations: event images, timestamp images, voxel grids."""

from .image import (  # noqa: F401
    events_to_image,
    events_to_image_drv,
    events_to_image_torch,
    events_to_timestamp_image,
    image_to_event_weights,
)
from .voxel_grid import events_to_voxel, events_to_voxel_tiled  # noqa: F401
