"""Raw-event-stream augmentation: host numpy ops and device torch ops
(port of ``event_utils_tpu.augmentation``; ``*_jax`` becomes ``*_torch``)."""

from .event_augmentation import (  # noqa: F401
    add_correlated_events,
    add_correlated_events_torch,
    add_random_events,
    block_to_events,
    crop_events,
    events_to_block,
    flip_events_x,
    flip_events_x_torch,
    flip_events_y,
    flip_events_y_torch,
    jitter_events_torch,
    merge_events,
    remove_events,
    remove_events_mask_torch,
    rotate_events,
    rotate_events_torch,
    sample,
)
