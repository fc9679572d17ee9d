"""Background-activity filter (port of ``event_utils_tpu.ops.denoise``).

An event is genuine if a NEIGHBOURING pixel fired within ``delta_t``
before it; isolated events (sensor leak/shot noise) have no such support
and are dropped. Time is quantized into ``n_slices`` slices and the filter
is four dense passes, as in JAX:

1. scatter-max of event times into a ``(S, H, W)`` per-slice last-time
   volume (``scatter_reduce_(..., "amax")``),
2. neighbourhood max over each slice, centre excluded so a lone hot or
   noisy pixel cannot validate itself,
3. running max over slices (``torch.cummax``),
4. per-event gather and compare against ``t - delta_t``.

Padded events neither vote nor survive. Events later in the SAME slice
can validate (a one-slice tolerance that shrinks as ``n_slices`` grows).
Every step is a max, a compare or an integer index, so the keep mask is
the same as JAX's bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._device import pick_device, to_numpy
from ..errors import ConfigurationError


def _as_input(a, dev) -> torch.Tensor:
    """Coordinates as JAX sees them with x64 off: floats as float32,
    integers as int64 (exact for any sensor)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    t = t.to(dev)
    return t.float() if t.is_floating_point() else t.long()


def _relative_stamps(ts, valid, dev) -> torch.Tensor:
    """Stamps relative to the first valid one, in float32.

    float64 stamps (epoch seconds) lose the origin in float64 first, as
    JAX does on the host, so a 1.7e9 s recording keeps its precision."""
    if not isinstance(ts, torch.Tensor):
        ts = torch.as_tensor(np.asarray(ts))
    ts = ts.to(dev)
    if ts.dtype == torch.float64 and ts.numel():
        sel = ts[valid]
        ts = ts - (sel.min() if sel.numel() else 0.0)
    ts = ts.float()
    t0 = torch.where(valid, ts, torch.inf).min() if ts.numel() \
        else torch.tensor(torch.inf, device=dev)
    t0 = torch.where(torch.isfinite(t0), t0, 0.0)
    return ts - t0


def background_activity_filter(xs, ys, ts, delta_t,
                               sensor_size: Tuple[int, int] = (180, 240),
                               n_slices: int = 64, support: int = 1,
                               include_center: bool = False,
                               mask=None, device=None) -> torch.Tensor:
    """Per-event keep mask of the spatiotemporal correlation filter.

    An event at ``(x, y, t)`` is kept iff some pixel within the
    ``(2*support+1)²`` neighbourhood carries an event in
    ``[t - delta_t, t]``, up to the one-slice quantization tolerance. The
    centre pixel never validates within its own slice;
    ``include_center=True`` also counts same-pixel events from strictly
    earlier slices. ``mask`` (``!= 0`` = real event) marks padding. Runs on
    the device of the first tensor among the inputs, else on ``device``
    (default ``"cuda"``).

    Returns:
        bool ``(N,)`` tensor: True = keep (signal), False = drop (noise).
    """
    if n_slices < 1:
        raise ConfigurationError(f"n_slices must be >= 1, got {n_slices}")
    if support < 1:
        raise ConfigurationError(f"support must be >= 1, got {support}")
    dev = pick_device(xs, ys, ts, mask, device=device)
    H, W = int(sensor_size[0]), int(sensor_size[1])
    S = int(n_slices)
    xs, ys = _as_input(xs, dev), _as_input(ys, dev)
    valid = (torch.ones(xs.shape, dtype=torch.bool, device=dev)
             if mask is None else _as_input(mask, dev) != 0)
    t = _relative_stamps(ts, valid, dev)

    t1 = torch.where(valid, t, -torch.inf).max() if t.numel() \
        else torch.tensor(-torch.inf, device=dev)
    t1 = torch.where(torch.isfinite(t1), t1, 0.0)
    slice_dt = torch.clamp(t1, min=1e-30) / S
    q = torch.clamp((t / slice_dt).to(torch.int32), 0, S - 1).long()

    xi = torch.clamp(xs.to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(ys.to(torch.int32), 0, H - 1).long()
    # xs < W (not <= W-1): fractional coords in (W-1, W) rasterize to the
    # last pixel, matching every scatter kernel in ops/
    in_frame = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H) & valid
    flat = q * (H * W) + yi * W + xi

    last = torch.full((S * H * W,), -torch.inf, device=dev)
    last.scatter_reduce_(0, flat[in_frame], t[in_frame], "amax")
    last = last.reshape(S, H, W)

    r = int(support)
    padded = torch.nn.functional.pad(last, (r, r, r, r), value=-torch.inf)
    ring = torch.full_like(last, -torch.inf)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                # never in `ring`: the event's own timestamp would validate
                # itself (keep == in_frame, a no-op filter)
                continue
            ring = torch.maximum(
                ring, padded[:, r + dy:r + dy + H, r + dx:r + dx + W])
    latest = torch.cummax(ring, dim=0).values  # latest support up to slice
    if include_center:
        # same-pixel support from STRICTLY EARLIER slices only
        cum_center = torch.cummax(last, dim=0).values
        prev_center = torch.cat(
            [torch.full((1, H, W), -torch.inf, device=dev), cum_center[:-1]])
        latest = torch.maximum(latest, prev_center)

    support_t = latest.reshape(-1)[flat.clamp(0, S * H * W - 1)]
    dt = torch.as_tensor(delta_t, dtype=torch.float32).to(dev)
    keep = support_t >= t - dt
    return keep & in_frame


def filter_background_activity(xs, ys, ts, ps, delta_t,
                               sensor_size: Tuple[int, int] = (180, 240),
                               **kwargs):
    """Host convenience: apply :func:`background_activity_filter` and
    return the surviving ``(xs, ys, ts, ps)`` as numpy arrays."""
    keep = to_numpy(background_activity_filter(
        xs, ys, ts, delta_t, sensor_size=sensor_size, **kwargs))
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    return xs[keep], ys[keep], ts[keep], ps[keep]
