"""Motion models (warps) and contrast objectives."""

from .warps import (  # noqa: F401
    WARP_REGISTRY,
    get_warp,
    linvel_warp,
    linvel_warp_fn,
    pure_rotation_warp,
    warp_function,
    xyztheta_warp,
)
from .objectives import (  # noqa: F401
    OBJECTIVE_REGISTRY,
    get_iwe,
    get_objective,
    isoa_objective,
    iwe_validity_mask,
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
