"""Event utilities (masks, clipping, windowing, search, hot pixels), crop
geometry, JSON and PNG helpers, the image-quality metrics, and throughput
meters, structured logging and profiler traces (``profiling``)."""

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
from .util import (  # noqa: F401
    CropParameters,
    ensure_dir,
    flow2bgr_np,
    format_power,
    gray_levels,
    hsv_to_rgb,
    inf_loop,
    normalize_image,
    optimal_crop_size,
    plot_image,
    plot_image_grid,
    read_json,
    save_image,
    write_gray_png,
    write_json,
    write_rgb_png,
)
from .metrics import average_endpoint_error, psnr, ssim  # noqa: F401
from .profiling import (  # noqa: F401
    ThroughputMeter,
    log_metrics,
    logger,
    timed,
    trace,
)
