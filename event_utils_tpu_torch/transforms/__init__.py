"""Dense-flow event warping."""

from .optic_flow import warp_events_flow, warp_events_flow_torch  # noqa: F401
