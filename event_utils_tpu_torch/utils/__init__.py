"""Event utilities: masks, clipping, windowing, search, hot-pixel removal."""

from .event_util import (  # noqa: F401
    binary_search_array,
    binary_search_torch_tensor,
    binary_search_h5_dset,
    binary_search_h5_timestamp,
    clip_events_to_bounds,
    cut_events_to_lifespan,
    events_bounds_mask,
    events_bounds_validity,
    get_events_from_mask,
    infer_resolution,
    lifespan_mask,
    remove_hot_pixels,
)
