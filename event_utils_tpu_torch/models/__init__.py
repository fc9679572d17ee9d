"""Motion models (warps), contrast objectives, and the learned networks
(EV-FlowNet, E2VID, rpg_e2vid's UNetRecurrent; E-RAFT in ``models.eraft``
and the RVT detector in ``models.rvt``, each imported where it is
built)."""

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
from .networks import (  # noqa: F401
    DETECTION_MODELS,
    E2VID,
    FLOW_MODELS,
    RECONSTRUCTION_MODELS,
    ConvGRU,
    ConvLSTM,
    EVFlowNet,
    PadConv,
    SameConv,
    UNetRecurrent,
    build_detector,
    contrast_flow_loss,
    init_lecun_normal,
    perceptual_distance,
    reconstruction_loss,
)
