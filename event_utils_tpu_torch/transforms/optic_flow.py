"""Dense-optic-flow event warping.

Port of ``event_utils_tpu.transforms.optic_flow`` (reference
``lib/transforms/optic_flow.py``). The reference looks up per-event flow
with ``F.grid_sample(align_corners=True)`` over coordinates normalized to
[-1, 1] (optic_flow.py:36-40); with align_corners that is a bilinear gather
at pixel coordinates, which is what this does (one 4-tap gather,
``ops.bilinear_gather``, over the field with a ring of zeros: the
reference's ``padding_mode='zeros'``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .._device import as_f32, as_tensor, pick_device
from ..ops.scatter import bilinear_gather


def warp_events_flow(xs, ys, ts, ps, flow_field, t0=None, mask=None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp each event along the dense flow at its location
    (reference optic_flow.py:5-46):

        x' = x + u(x, y) * (t - t0),    y' = y + v(x, y) * (t - t0)

    SIGN CONVENTION (reference-faithful, as in the JAX package): with the
    default ``t0 = t_last``, ``dt <= 0``, so this moves events AGAINST the
    sampled flow. Events from a feature moving at true scene velocity
    ``+v`` align only when ``flow_field = -v``: the function treats its
    input as *backward* flow. To compensate a forward flow (a simulator's
    ground truth, what EV-FlowNet emits), pass ``-flow_field``.

    @param flow_field ``(2, H, W)``: channel 0 = x-flow u, channel 1 =
        y-flow v (extra leading singleton dims are squeezed).
    @param t0 Reference time (defaults to the last valid event's timestamp;
        an all-masked window falls back to 0, keeping warps finite).
    @param device Where numpy inputs go (default the card)
    @returns ``(warped_xs, warped_ys)``, float32 tensors.
    """
    del ps
    dev = pick_device(flow_field, xs, ys, ts, mask, device=device)

    def _flatten(a):
        # only multi-dim inputs are flattened: a single-event (1,) array
        # must stay 1-D (the reference's squeeze would make it 0-d)
        a = as_f32(a, dev)
        return a.reshape(-1) if a.dim() != 1 else a

    xs, ys, ts = _flatten(xs), _flatten(ys), _flatten(ts)
    flow_field = as_f32(flow_field, dev)
    while flow_field.dim() > 3:
        flow_field = flow_field.squeeze(0)
    if t0 is None:
        if mask is None:
            t0 = ts[-1]
        else:
            valid = as_tensor(mask, dev) != 0
            t0 = torch.where(
                valid.any(),
                torch.where(valid, ts, -torch.inf).max(),
                torch.zeros((), device=dev))

    # padding_mode='zeros': samples outside the field fade bilinearly to
    # zero flow over the border pixel and are exactly zero beyond — a zero
    # ring and a shifted, clamped gather reproduce it exactly
    H, W = flow_field.shape[-2:]
    padded = F.pad(flow_field, (1, 1, 1, 1))
    cx = torch.clamp(xs + 1.0, 0.0, W + 1.0)
    cy = torch.clamp(ys + 1.0, 0.0, H + 1.0)
    u = bilinear_gather(cx, cy, padded[0])
    v = bilinear_gather(cx, cy, padded[1])
    dt = ts - t0
    xw = xs + u * dt
    yw = ys + v * dt
    if mask is not None:
        m = as_tensor(mask, dev) != 0
        xw = torch.where(m, xw, xs)
        yw = torch.where(m, yw, ys)
    return xw, yw


def warp_events_flow_torch(xt, yt, tt, pt, flow_field, t0=None,
                           batched=False, batch_indices=None, **kw):
    """Reference-signature alias (optic_flow.py:5); unbatched only."""
    if batched or batch_indices is not None:
        raise NotImplementedError(
            "batched warp_events_flow_torch is not supported; call "
            "warp_events_flow once per item")
    return warp_events_flow(xt, yt, tt, pt, flow_field, t0=t0, **kw)
