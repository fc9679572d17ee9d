"""Contrast maximisation: optimizers, grid search and the ROI-tiled solvers.

Warp models and objectives live in ``event_utils_tpu_torch.models`` and are
re-exported here, as in the JAX package.
"""

from ..models.objectives import (  # noqa: F401
    OBJECTIVE_REGISTRY,
    get_iwe,
    get_objective,
    isoa_objective,
    moa_objective,
    objective_function,
    r1_objective,
    rms_objective,
    soe_objective,
    sos_objective,
    sosa_objective,
    variance_objective,
    zhu_timestamp_objective,
)
from ..models.warps import (  # noqa: F401
    WARP_REGISTRY,
    get_warp,
    linvel_warp,
    pure_rotation_warp,
    warp_function,
    xyztheta_warp,
)
from .bfgs import minimize_bfgs  # noqa: F401
from .events_cmax import (  # noqa: F401
    AUTO_MAG_FLOOR,
    AUTO_REL_COH_TAU,
    AUTO_SCENE_FRAC,
    OVERFLOW_CAP_MAX,
    PATCH_DEFAULT,
    bucket_events_by_roi,
    draw_objective_function,
    find_new_range,
    fit_global_motion,
    get_hsv_shifted,
    grid_cmax,
    grid_cmax_batched,
    grid_search_initial,
    grid_search_optimisation,
    grid_search_refine,
    grid_search_refine_batched,
    make_objective_loss,
    make_patch_loss,
    make_patch_variance_loss,
    make_roi_solve_one,
    optimize,
    optimize_contrast,
    optimize_contrast_jit,
    optimize_r2,
    recursive_search,
    segmentation_mask_from_d_iwe,
    xyztheta_velocity_at,
)
