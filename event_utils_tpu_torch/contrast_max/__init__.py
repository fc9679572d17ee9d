"""Contrast maximisation: optimizers and grid search.

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
    find_new_range,
    grid_search_initial,
    grid_search_optimisation,
    grid_search_refine,
    make_objective_loss,
    optimize,
    optimize_contrast,
    optimize_contrast_jit,
    optimize_r2,
    recursive_search,
)
