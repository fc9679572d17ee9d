"""Event-stream primitives: bounds masks, clipping, windowing, hot pixels
(port of ``event_utils_tpu.utils.event_util``).

Two styles of every selection op, as in the JAX package:

- a *mask* form (tensors on the device, static shapes — the loss path), and
- a *drop* form (host-side numpy, dynamic shapes — the data-prep path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import as_tensor, pick_device, to_numpy
from ..errors import ConfigurationError


def infer_resolution(xs, ys) -> Tuple[int, int]:
    """Guess sensor resolution from max coords (reference event_util.py:5-13)."""
    return (int(np.max(to_numpy(ys))) + 1, int(np.max(to_numpy(xs))) + 1)


def events_bounds_mask(xs, ys, x_min, x_max, y_min, y_max, device=None):
    """Float mask of events inside the given bounds.

    The reference's asymmetric inclusivity: an event is *out* when
    ``x <= x_min`` or ``x > x_max`` (same for y) — the lower bound is
    exclusive and the upper bound inclusive.
    """
    dev = pick_device(xs, ys, device=device)
    xs, ys = as_tensor(xs, dev), as_tensor(ys, dev)
    out_x = (xs <= x_min) | (xs > x_max)
    out_y = (ys <= y_min) | (ys > y_max)
    return (~(out_x | out_y)).to(torch.float32)


def clip_events_to_bounds(xs, ys, ts, ps, bounds, set_zero: bool = False,
                          device=None):
    """Clip events to bounds (reference event_util.py:61-94).

    @param bounds length-2 ``[max_y, max_x]`` (lower bound 0) or length-4
        ``[min_y, max_y, min_x, max_x]``
    @param set_zero if True, return masked (coord-preserving) tensors as in
        the reference's multiply-by-mask mode; else drop out-of-bounds
        events (host-side numpy, dynamic shape).
    """
    if len(bounds) == 2:
        bounds = [0, bounds[0], 0, bounds[1]]
    elif len(bounds) != 4:
        raise ConfigurationError(
            f"Bounds must be of length 2 or 4 (not {len(bounds)})")
    miny, maxy, minx, maxx = bounds
    if set_zero:
        dev = pick_device(xs, ys, ts, ps, device=device)
        mask = events_bounds_mask(xs, ys, minx, maxx, miny, maxy, device=dev)
        return tuple(None if a is None else as_tensor(a, dev) * mask
                     for a in (xs, ys, ts, ps))
    xs, ys = to_numpy(xs), to_numpy(ys)
    keep = (xs >= minx) & (xs < maxx) & (ys >= miny) & (ys < maxy)
    return (xs[keep], ys[keep],
            None if ts is None else to_numpy(ts)[keep],
            None if ps is None else to_numpy(ps)[keep])


def events_bounds_validity(xs, ys, sensor_size, device=None) -> torch.Tensor:
    """Boolean mask of events inside ``[0, W) x [0, H)``."""
    H, W = sensor_size
    dev = pick_device(xs, ys, device=device)
    xs, ys = as_tensor(xs, dev), as_tensor(ys, dev)
    return (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)


def cut_events_to_lifespan(xs, ys, ts, ps, params, pixel_crossings,
                           minimum_events: int = 100, side: str = "back"):
    """Cut events down to a motion-implied lifespan (event_util.py:30-59).

    Host-side numpy (dynamic shape). Lifespan dt = pixel_crossings / |params|.
    The reference slices ``[s_idx:-1]`` (drops the final event); replicated.
    """
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    magnitude = float(np.linalg.norm(to_numpy(params)))
    dt = pixel_crossings / magnitude
    if side == "back":
        s_idx = int(np.searchsorted(ts, ts[-1] - dt))
        if len(xs) - s_idx < minimum_events:
            s_idx = len(xs) - minimum_events
        return xs[s_idx:-1], ys[s_idx:-1], ts[s_idx:-1], ps[s_idx:-1]
    if side == "front":
        s_idx = int(np.searchsorted(ts, dt + ts[0]))
        if s_idx < minimum_events:
            s_idx = minimum_events
        return xs[0:s_idx], ys[0:s_idx], ts[0:s_idx], ps[0:s_idx]
    raise ConfigurationError(
        f"Invalid side {side!r}: must be 'front' or 'back'")


def lifespan_mask(ts, params, pixel_crossings: float,
                  minimum_events: int = 10000,
                  base_mask: Optional[torch.Tensor] = None,
                  drop_last: bool = True, device=None) -> torch.Tensor:
    """Mask form of the adaptive lifespan cut (fixed capacity, no sync).

    Events with ``t >= t_last - lifespan`` stay on; if that leaves fewer
    than ``minimum_events``, the newest ``minimum_events`` valid events stay
    on instead. Lifespan = pixel_crossings / |params| (5 s when |params| is
    0). ``drop_last`` excludes the final valid event, as the reference's
    ``[s_idx:-1]`` does. Returns a float mask of shape (N,).
    """
    dev = pick_device(ts, base_mask, params, device=device)
    ts = as_tensor(ts, dev)
    n = ts.shape[0]
    if base_mask is None:
        base_mask = torch.ones_like(ts)
    base_mask = as_tensor(base_mask, dev)
    valid = base_mask != 0
    params = as_tensor(params, dev).to(torch.float32)
    magnitude = torch.linalg.vector_norm(torch.atleast_1d(params))
    dt = torch.where(magnitude == 0, 5.0,
                     pixel_crossings / torch.clamp(magnitude, min=1e-30))
    t_last = torch.where(valid, ts, -torch.inf).max()
    keep_time = valid & (ts >= t_last - dt)
    num_valid = valid.sum()
    num_kept = keep_time.sum()
    rank_from_end = num_valid - torch.cumsum(valid, 0)  # 0 = last valid event
    keep_min = valid & (rank_from_end < minimum_events)
    keep = torch.where(num_kept < minimum_events, keep_min, keep_time)
    if drop_last:
        pos = torch.arange(n, device=dev)
        last_valid = torch.where(valid, pos, -1).max()
        keep = keep & (pos < last_valid)
    return base_mask * keep.to(base_mask.dtype)


def get_events_from_mask(mask, xs, ys):
    """Indices of events lying on nonzero pixels of an image mask
    (reference event_util.py:96-109). Host-side."""
    xs = to_numpy(xs).astype(int)
    ys = to_numpy(ys).astype(int)
    vals = to_numpy(mask)[ys, xs]
    return np.argwhere(vals >= 0.01).squeeze()


def binary_search_h5_dset(dset, x, l=None, r=None, side="left"):
    """Binary search a (sorted, on-disk) HDF5 dataset without loading it
    (reference event_util.py:111-135)."""
    l = 0 if l is None else l
    r = len(dset) - 1 if r is None else r
    while l <= r:
        mid = l + (r - l) // 2
        midval = dset[mid]
        if midval == x:
            return mid
        elif midval < x:
            l = mid + 1
        else:
            r = mid - 1
    return l if side == "left" else r


def binary_search_h5_timestamp(hdf_path, l, r, x, side="left"):
    import h5py
    with h5py.File(hdf_path, "r") as f:
        return binary_search_h5_dset(f["events/ts"], x, l=l, r=r, side=side)


def binary_search_array(t, x, l=0, r=None, side="left"):
    """Binary search of a sorted tensor or array over ``[l, r)``."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    r = t.shape[0] if r is None else r
    val = torch.as_tensor(x, dtype=t.dtype, device=t.device)
    return int(torch.searchsorted(t[l:r], val, side=side)) + l


def binary_search_torch_tensor(t, l, r, x, side="left"):
    """Reference-name entry (event_util.py:141); the reference's ``r`` is
    inclusive, ``binary_search_array`` slices exclusively, so widen by one."""
    n = len(t)
    r_excl = n if r is None else min(int(r) + 1, n)
    return binary_search_array(t, x, l=l or 0, r=r_excl, side=side)


def remove_hot_pixels(xs, ys, ts, ps, sensor_size=(180, 240),
                      num_hot: int = 50, device=None):
    """Remove events from the ``num_hot`` highest-count pixels
    (reference event_util.py:166-187). Host-side selection; the event image
    is formed on ``device``."""
    from ..representations.image import events_to_image

    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    img = to_numpy(events_to_image(xs, ys, ps, sensor_size=sensor_size,
                                   device=device)).copy()
    hot_mask = np.zeros(len(xs), dtype=bool)
    for _ in range(num_hot):
        maxc = np.unravel_index(np.argmax(img), sensor_size)
        img[maxc] = 0
        hot_mask |= (xs == maxc[1]) & (ys == maxc[0])
    keep = ~hot_mask
    return xs[keep], ys[keep], ts[keep], ps[keep]
