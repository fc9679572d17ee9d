"""Temporally-bilinear voxel grids (port of
``event_utils_tpu.representations.voxel_grid``).

Each event adds ``ps * max(0, 1-|t_norm-b|)`` to the (at most) two bins
bracketing it, in one flattened ``B*H*W`` scatter. Spatial accumulation
truncates coordinates to integers, as the reference's torch path does;
``spatial_interpolation='bilinear'`` splats 4 spatial taps instead.

``impl='matmul*'`` (with the default temporal-bilinear, integer-coordinate
route) runs the hand-written CUDA voxel kernel (``ops.cuda_scatter``).
The ``impl='tiled'`` route and ``events_to_voxel_tiled`` are not ported yet
and raise ``ConfigurationError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import as_f32, as_tensor, pick_device
from ..errors import ConfigurationError
from ..ops.cuda_scatter import voxel_matmul
from ..ops.scatter import bilinear_scatter, scatter_add_2d, scatter_add_flat

_PRECISION = {"matmul": "hilo", "matmul_hilo": "hilo",
              "matmul_bf16": "bf16", "matmul_int8": "int8"}


def events_to_voxel(xs, ys, ts, ps, B: int, sensor_size=(180, 240),
                    temporal_bilinear: bool = True,
                    spatial_interpolation: Optional[str] = None,
                    mask=None, t0=None, t1=None,
                    impl: Optional[str] = None, device=None) -> torch.Tensor:
    """Turn events into a ``(B, H, W)`` voxel grid.

    Matches reference ``events_to_voxel_torch`` (voxel_grid.py:114-153):
    ``t_norm = (ts - t_first) / (t_last - t_first) * (B-1)``; each event adds
    ``ps * max(0, 1 - |t_norm - bi|)`` to bin ``bi`` at its (integer) pixel.
    With ``temporal_bilinear=False`` events go to B equal-duration slices.

    @param mask Optional per-event validity mask (padded batches)
    @param t0, t1 Override the time window (default: first/last valid event)
    @param device Where numpy inputs go (default the card)
    """
    H, W = sensor_size
    dev = pick_device(xs, ys, ts, ps, mask, device=device)
    xs = as_tensor(xs, dev)
    ys = as_tensor(ys, dev)
    ts = as_f32(ts, dev)
    ps = as_f32(ps, dev)
    if mask is not None:
        mask = as_tensor(mask, dev)

    if impl == "tiled":
        raise ConfigurationError(
            "impl='tiled' (events_to_voxel_tiled, the large-sensor route) is "
            "not yet ported to event_utils_tpu_torch")
    if impl in _PRECISION and temporal_bilinear \
            and spatial_interpolation is None:
        # CUDA voxel kernel; the callers' events are time-sorted, as every
        # reader of the JAX package guarantees
        return voxel_matmul(xs, ys, ts, ps, B, sensor_size=sensor_size,
                            mask=mask, t0=t0, t1=t1,
                            precision=_PRECISION[impl])
    if impl == "matmul_int8":
        # int8 exists only for the voxel kernel; every other route maps it
        # to the hilo route (same tolerance class)
        impl = "matmul"

    if t0 is None or t1 is None:
        if mask is None:
            t_first, t_last = ts[0], ts[-1]
        else:
            big = torch.finfo(torch.float32).max
            t_first = torch.where(mask != 0, ts, big).min()
            t_last = torch.where(mask != 0, ts, -big).max()
        t0 = t_first if t0 is None else t0
        t1 = t_last if t1 is None else t1
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    dt = t1 - t0
    dt = torch.where(dt == 0, 1.0, dt)

    if mask is not None:
        ps = ps * mask.to(ps.dtype)

    ixs = torch.trunc(xs.to(torch.float32)).long()
    iys = torch.trunc(ys.to(torch.float32)).long()
    in_img = (ixs >= 0) & (ixs < W) & (iys >= 0) & (iys < H)

    if temporal_bilinear:
        t_norm = (ts - t0) / dt * (B - 1)
        b0 = torch.floor(t_norm)
        fb = t_norm - b0
        ib0 = torch.where(torch.isfinite(b0), b0, -1.0).long()

        if spatial_interpolation == "bilinear":
            fx = xs.to(torch.float32)
            fy = ys.to(torch.float32)
            # Bin stride H+1: each bin gets one guard row so a y0+1 tap of
            # an event with fy in (H-1, H) lands in its own bin's guard row
            # (sliced away) instead of the next bin's row 0, and a y0 tap of
            # fy in (-1, 0) lands in the previous bin's guard row.
            SH = H + 1
            # events with no valid y tap must be dropped entirely
            y_ok = (fy > -1.0) & (fy < H)
            flat = []
            for ib, wb in ((ib0, 1.0 - fb), (ib0 + 1, fb)):
                bin_ok = (ib >= 0) & (ib < B) & y_ok
                m = bin_ok.to(torch.float32)
                flat.append((fx, fy + ib.clamp(0, B - 1).to(torch.float32)
                             * SH, ps * wb * m))
            img = bilinear_scatter(
                torch.cat([f[0] for f in flat]),
                torch.cat([f[1] for f in flat]),
                torch.cat([f[2] for f in flat]),
                (B * SH, W), impl=impl)
            return img.view(B, SH, W)[:, :H, :]

        # integer-coordinate route (reference parity): 2 temporal taps
        flat_px = iys * W + ixs
        ids, ws = [], []
        for ib, wb in ((ib0, 1.0 - fb), (ib0 + 1, fb)):
            ok = in_img & (ib >= 0) & (ib < B)
            ids.append(torch.where(ok, ib * (H * W) + flat_px, -1))
            ws.append(ps * wb)
        flat = scatter_add_flat(torch.cat(ids), torch.cat(ws), B * H * W,
                                impl=impl)
        return flat.view(B, H, W)

    # equal-duration slice binning (non-bilinear); the int cast truncates
    bin_idx = ((ts - t0) / dt * B).to(torch.int32).long().clamp(0, B - 1)
    if impl in ("matmul", "matmul_hilo", "matmul_bf16"):
        # flat id bin*H*W + iy*W + ix == (bin*H + iy)*W + ix: the whole grid
        # is one (B*H, W) image scatter; out-of-image events get row -1
        iy_eff = torch.where(in_img, bin_idx * H + iys, -1)
        img = scatter_add_2d(torch.where(in_img, ixs, -1), iy_eff, ps,
                             (B * H, W), impl=impl)
        return img.view(B, H, W)
    ids = torch.where(in_img, bin_idx * (H * W) + iys * W + ixs, -1)
    flat = scatter_add_flat(ids, ps, B * H * W, impl=impl)
    return flat.view(B, H, W)


def events_to_voxel_tiled(*args, **kwargs):
    """The spatially-tiled large-sensor voxel builder of the JAX package
    (``voxel_matmul_tiles``) — not yet ported."""
    raise ConfigurationError(
        "events_to_voxel_tiled is not yet ported to event_utils_tpu_torch")
