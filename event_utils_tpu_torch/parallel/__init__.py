"""Multi-card scaling on ``torch.distributed``: device meshes,
event-sharded accumulation, ROI sharding (port of
``event_utils_tpu.parallel``)."""

from .sharding import (  # noqa: F401
    make_mesh,
    pad_to_multiple,
    shard_events,
    make_sharded_cmax_train_step,
    sharded_cmax_train_step,
    sharded_events_to_timestamp_image,
    sharded_events_to_voxel,
    sharded_grid_cmax,
    sharded_iwe,
)
