"""Raw-event-stream augmentation (port of
``event_utils_tpu.augmentation.event_augmentation``).

Two flavours, as in the JAX package:

* **Host (numpy) ops** with reference-compatible signatures. They change
  the number of events (add/remove/merge), so they live on the host where
  shapes are free. Randomness goes through an explicit
  ``numpy.random.Generator`` (``rng=``); with the same seed they give the
  JAX package's arrays bit for bit.
* **Device ops** (``*_torch``, JAX's ``*_jax``): capacity-preserving
  transforms (flip, rotate, jitter, the 2x densify, a keep-mask) on
  tensors. Each random one is split into a draw from an explicit
  ``torch.Generator`` (JAX's ``key``) and a deterministic core that takes
  the draws (``_jitter_core``, ``_densify_core``, ``_rotate_core``,
  ``_remove_mask_core``), so that the cores can be fed JAX's own draws.

Documented divergences from catalogued reference bugs (SURVEY.md §7.3),
as in the JAX package: ``rotate_events`` applies a true rotation about the
centre, and ``flip_events_*`` map ``c -> (res-1) - c``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_f32, as_tensor, pick_device, to_numpy
from ..ops.sort import time_sort


def _default_rng(rng):
    return np.random.default_rng() if rng is None else rng


# ---------------------------------------------------------------------------
# Host (numpy) ops
# ---------------------------------------------------------------------------

def events_to_block(xs, ys, ts, ps) -> np.ndarray:
    """Stack event components into an ``(N, 4)`` block
    (reference event_augmentation.py:23-38)."""
    return np.stack([np.asarray(xs), np.asarray(ys), np.asarray(ts),
                     np.asarray(ps)], axis=1)


def block_to_events(block):
    return block[:, 0], block[:, 1], block[:, 2], block[:, 3]


def merge_events(event_sets, sort: bool = False):
    """Concatenate several (xs, ys, ts, ps) streams into one block
    (reference event_augmentation.py:40-58); optionally time-sort."""
    xs = np.concatenate([np.asarray(e[0]) for e in event_sets])
    ys = np.concatenate([np.asarray(e[1]) for e in event_sets])
    ts = np.concatenate([np.asarray(e[2]) for e in event_sets])
    ps = np.concatenate([np.asarray(e[3]) for e in event_sets])
    block = events_to_block(xs, ys, ts, ps)
    if sort:
        block = block[np.argsort(block[:, 2], kind="stable")]
    return block


def sample(cdf, ts, rng=None):
    """Draw an event index by sampling a CDF over timestamps
    (reference event_augmentation.py:8-21).

    Reference-parity quirk kept: the draw is uniform over the *CDF's value
    range* but searchsorted against ``ts``."""
    rng = _default_rng(rng)
    rnd = rng.uniform(cdf[0], cdf[-1])
    return int(np.searchsorted(ts, rnd))


def _sorted_out(block, sort):
    if sort:
        block = block[np.argsort(block[:, 2], kind="stable")]
    return block[:, 0], block[:, 1], block[:, 2], block[:, 3]


def add_random_events(xs, ys, ts, ps, to_add, sensor_resolution=None,
                      sort: bool = True, return_merged: bool = True,
                      rng=None):
    """Add uniform-noise events over the stream's spatial/temporal extent
    (reference event_augmentation.py:60-92)."""
    rng = _default_rng(rng)
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    if sensor_resolution is None:
        max_x, max_y = int(np.max(xs)) + 1, int(np.max(ys)) + 1
    else:
        max_y, max_x = sensor_resolution
    xs_new = rng.integers(0, max_x, size=to_add).astype(xs.dtype)
    ys_new = rng.integers(0, max_y, size=to_add).astype(ys.dtype)
    ts_new = rng.uniform(np.min(ts), np.max(ts), size=to_add)
    ps_new = rng.integers(0, 2, size=to_add) * 2 - 1
    if return_merged:
        block = merge_events([[xs_new, ys_new, ts_new, ps_new],
                              [xs, ys, ts, ps]])
        return _sorted_out(block, sort)
    block = events_to_block(xs_new, ys_new, ts_new, ps_new)
    return _sorted_out(block, sort)


def remove_events(xs, ys, ts, ps, to_remove, add_noise: int = 0, rng=None):
    """Randomly drop ``to_remove`` events, optionally replacing with noise
    (reference event_augmentation.py:94-116)."""
    rng = _default_rng(rng)
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    if to_remove > len(xs):
        return (np.array([]),) * 4
    keep = len(xs) - to_remove
    idx = rng.choice(len(xs), size=keep, replace=False)
    idx.sort()
    if add_noise <= 0:
        return xs[idx], ys[idx], ts[idx], ps[idx]
    nsx, nsy, nst, nsp = add_random_events(xs, ys, ts, ps, add_noise,
                                           sort=False, return_merged=False,
                                           rng=rng)
    block = merge_events([[xs[idx], ys[idx], ts[idx], ps[idx]],
                          [nsx, nsy, nst, nsp]])
    return _sorted_out(block, True)


def add_correlated_events(xs, ys, ts, ps, to_add, sort: bool = True,
                          return_merged: bool = True, xy_std: float = 1.5,
                          ts_std: float = 0.001, add_noise: int = 0,
                          rng=None):
    """Densify: place a Gaussian bubble of new events around existing ones
    (reference event_augmentation.py:118-157). Every event spawns
    ``to_add // n`` bubbles plus a without-replacement remainder; only the
    source indices are materialised."""
    rng = _default_rng(rng)
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    n = len(xs)
    full = to_add // n
    src = np.arange(n, dtype=np.int64)
    parts = [np.tile(src, full)] if full else []
    rem = to_add - full * n
    if rem:
        parts.append(rng.choice(n, size=rem, replace=False))
    src = np.concatenate(parts) if parts else np.empty(0, np.int64)
    xs_new = np.clip(xs[src] + rng.normal(scale=xy_std,
                                          size=to_add).astype(int),
                     0, np.max(xs))
    ys_new = np.clip(ys[src] + rng.normal(scale=xy_std,
                                          size=to_add).astype(int),
                     0, np.max(ys))
    ts_new = ts[src] + rng.normal(scale=ts_std, size=to_add)
    ps_new = ps[src]
    sets = [[xs_new, ys_new, ts_new, ps_new]]
    if add_noise > 0:
        sets.append(add_random_events(xs, ys, ts, ps, add_noise, sort=False,
                                      return_merged=False, rng=rng))
    if return_merged:
        sets.append([xs, ys, ts, ps])
    cx = np.concatenate([s[0] for s in sets])
    cy = np.concatenate([s[1] for s in sets])
    ct = np.concatenate([s[2] for s in sets])
    cp = np.concatenate([s[3] for s in sets])
    if sort:
        order = np.argsort(ct, kind="stable")
        return cx[order], cy[order], ct[order], cp[order]
    return cx, cy, ct, cp


def flip_events_x(xs, ys, ts, ps, sensor_resolution=(180, 240)):
    """Mirror events along x (reference event_augmentation.py:159-169;
    off-by-one fixed: ``x -> (W-1) - x``)."""
    return sensor_resolution[1] - 1 - np.asarray(xs), ys, ts, ps


def flip_events_y(xs, ys, ts, ps, sensor_resolution=(180, 240)):
    """Mirror events along y (reference event_augmentation.py:171-181;
    off-by-one fixed: ``y -> (H-1) - y``)."""
    return xs, sensor_resolution[0] - 1 - np.asarray(ys), ts, ps


def crop_events(xs, ys, sensor_resolution, new_resolution):
    """Crop events to a smaller resolution
    (reference event_augmentation.py:183-193)."""
    from ..utils.event_util import clip_events_to_bounds
    clip = clip_events_to_bounds(xs, ys, None, None, new_resolution)
    return clip[0], clip[1]


def rotate_events(xs, ys, sensor_resolution=(180, 240), theta_radians=None,
                  center_of_rotation=None, clip_to_range: bool = False,
                  rng=None):
    """Rotate events about a centre (reference event_augmentation.py:195-223,
    with the rotation corrected: ``p' = c + R(theta) (p - c)``).

    Returns ``(xs', ys', theta_radians, center_of_rotation)``.
    """
    rng = _default_rng(rng)
    xs, ys = np.asarray(xs), np.asarray(ys)
    if theta_radians is None:
        theta_radians = rng.uniform(0, 2 * np.pi)
    if center_of_rotation is None:
        center_of_rotation = (int(rng.uniform(0, sensor_resolution[1])),
                              int(rng.uniform(0, sensor_resolution[0])))
    cx, cy = center_of_rotation
    rx = xs - cx
    ry = ys - cy
    c, s = np.cos(theta_radians), np.sin(theta_radians)
    new_xs = c * rx - s * ry + cx
    new_ys = s * rx + c * ry + cy
    if clip_to_range:
        from ..utils.event_util import clip_events_to_bounds
        clip = clip_events_to_bounds(new_xs, new_ys, None, None,
                                     sensor_resolution)
        new_xs, new_ys = clip[0], clip[1]
    return new_xs, new_ys, theta_radians, center_of_rotation


# ---------------------------------------------------------------------------
# Device ops (capacity-preserving, on tensors)
# ---------------------------------------------------------------------------

def _draw_device(arrays, device, generator) -> torch.device:
    """The inputs' device; for host inputs ``device``, else the
    generator's, else the card."""
    if (device is None and generator is not None
            and not any(isinstance(a, torch.Tensor) for a in arrays)):
        device = generator.device
    return pick_device(*arrays, device=device)


def _normal(shape, generator, dev) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=dev)


def flip_events_x_torch(xs, ys, ts, ps, sensor_resolution=(180, 240),
                        device=None):
    dev = pick_device(xs, device=device)
    return sensor_resolution[1] - 1 - as_tensor(xs, dev), ys, ts, ps


def flip_events_y_torch(xs, ys, ts, ps, sensor_resolution=(180, 240),
                        device=None):
    dev = pick_device(ys, device=device)
    return xs, sensor_resolution[0] - 1 - as_tensor(ys, dev), ts, ps


def _rotate_core(xs, ys, theta, cx, cy):
    """Rotation of f32 coordinates by ``theta`` about ``(cx, cy)``.

    ``cos`` and ``sin`` are taken in float64 and rounded to f32, so that
    the card and the CPU use the same two factors (their f32 ``cos`` may
    differ in the last place) and the rest is f32 products and sums.
    """
    theta = torch.as_tensor(theta, dtype=torch.float32, device=xs.device)
    c = torch.cos(theta.double()).float()
    s = torch.sin(theta.double()).float()
    rx = xs - cx
    ry = ys - cy
    return c * rx - s * ry + cx, s * rx + c * ry + cy


def rotate_events_torch(xs, ys, sensor_resolution=(180, 240),
                        theta_radians=None, center_of_rotation=None,
                        generator=None, device=None):
    """Device rotation; returns ``(xs', ys', theta, center)``. A missing
    ``theta_radians`` is drawn from U(0, 2 pi) and a missing centre from
    U(0, W) x U(0, H), with ``generator``."""
    dev = _draw_device((xs, ys), device, generator)
    xs, ys = as_f32(xs, dev), as_f32(ys, dev)
    if theta_radians is None or center_of_rotation is None:
        u = torch.rand(3, generator=generator, device=dev)
        if theta_radians is None:
            theta_radians = u[0] * (2 * math.pi)
        if center_of_rotation is None:
            center_of_rotation = (u[1] * float(sensor_resolution[1]),
                                  u[2] * float(sensor_resolution[0]))
    cx, cy = center_of_rotation
    nx, ny = _rotate_core(xs, ys, theta_radians, cx, cy)
    return nx, ny, theta_radians, center_of_rotation


def _f32_time_offset(ts) -> float:
    """Host-side float64 origin to subtract before a float32 device cast.

    Absolute (epoch-style) stamps ~1e9 s have a float32 ulp of ~128 s: a
    cast would collapse every stamp of a window into one value. Device ops
    therefore work in relative time, and the caller's float64 origin is
    added back on return. Tensors (already f32 on a device) get offset 0.
    """
    if isinstance(ts, (np.ndarray, list, tuple)) and len(ts):
        return float(np.asarray(ts).reshape(-1)[0])
    return 0.0


def _relative_f32(ts, t0: float, dev) -> torch.Tensor:
    """``ts - t0`` as f32 on ``dev`` (the subtraction in the input's own
    numpy type, as in the JAX package)."""
    return as_f32(np.asarray(ts) - t0 if t0 else ts, dev)


def _restore_time_origin(t_rel, t0: float):
    """Add the float64 time origin back onto a relative-time result: a
    float64 numpy array on the host at full precision (the tensor itself
    when the origin is 0)."""
    if not t0:
        return t_rel
    return to_numpy(t_rel).astype(np.float64) + t0


def _jitter(xs, ys, ts_rel, zx, zy, zt, xy_std: float, ts_std: float):
    """Jitter by standard-normal draws ``zx, zy, zt``: coordinates move by
    ``trunc(z * xy_std)`` pixels, relative f32 stamps by ``z * ts_std``
    seconds."""
    nx = xs + torch.trunc(zx * xy_std)
    ny = ys + torch.trunc(zy * xy_std)
    nt = ts_rel + zt * ts_std
    return nx, ny, nt


def _jitter_core(xs, ys, ts, zx, zy, zt, xy_std: float = 1.5,
                 ts_std: float = 0.001, device=None):
    """``jitter_events_torch`` given its standard-normal draws."""
    dev = pick_device(xs, ys, ts, zx, device=device)
    t0 = _f32_time_offset(ts)
    nx, ny, nt = _jitter(as_f32(xs, dev), as_f32(ys, dev),
                         _relative_f32(ts, t0, dev), zx, zy, zt, xy_std,
                         ts_std)
    return nx, ny, _restore_time_origin(nt, t0)


def jitter_events_torch(xs, ys, ts, xy_std: float = 1.5,
                        ts_std: float = 0.001, generator=None, device=None):
    """Gaussian spatio-temporal jitter, the device core of
    ``add_correlated_events``. Host (numpy) stamps may be absolute
    float64: they are jittered in relative f32 time and the origin is
    restored, so epoch-style stamps keep sub-ms resolution."""
    dev = _draw_device((xs, ys, ts), device, generator)
    zx, zy, zt = _normal((3, len(ts)), generator, dev)
    return _jitter_core(xs, ys, ts, zx, zy, zt, xy_std, ts_std, device=dev)


def _densify_core(xs, ys, ts, ps, mask, zx, zy, zt, xy_std: float = 1.5,
                  ts_std: float = 0.001, sensor_resolution=(180, 240),
                  sort: bool = True, sort_block="auto", device=None):
    """``add_correlated_events_torch`` given its standard-normal draws
    ``zx, zy, zt`` (one per event)."""
    H, W = sensor_resolution
    dev = pick_device(xs, ys, ts, ps, mask, zx, device=device)
    t0 = _f32_time_offset(ts)
    xs, ys, ps = as_f32(xs, dev), as_f32(ys, dev), as_f32(ps, dev)
    ts = _relative_f32(ts, t0, dev)
    mask = torch.ones_like(ts) if mask is None else as_f32(mask, dev)
    nx, ny, nt = _jitter(xs, ys, ts, zx, zy, zt, xy_std, ts_std)
    nx = torch.clamp(nx, 0, W - 1)
    ny = torch.clamp(ny, 0, H - 1)
    if not sort:
        return (torch.cat([xs, nx]), torch.cat([ys, ny]),
                _restore_time_origin(torch.cat([ts, nt]), t0),
                torch.cat([ps, ps]), torch.cat([mask, mask]))

    # interleave [orig_i, copy_i] pairs as the JAX package does: the stable
    # sort then breaks ties between keys in its order
    def interleave(a, b):
        return torch.stack([a, b], dim=1).reshape(-1)

    cm = interleave(mask, mask)
    ct = interleave(ts, nt)
    keys = torch.where(cm != 0, ct, torch.tensor(float("inf"), device=dev))
    _, cx, cy, ct, cp, cm = time_sort(keys, interleave(xs, nx),
                                      interleave(ys, ny), ct,
                                      interleave(ps, ps), cm)
    return cx, cy, _restore_time_origin(ct, t0), cp, cm


def add_correlated_events_torch(xs, ys, ts, ps, mask=None,
                                xy_std: float = 1.5, ts_std: float = 0.001,
                                sensor_resolution=(180, 240),
                                sort: bool = True, sort_block="auto",
                                generator=None, device=None):
    """On-device 2x densify: every event spawns one jittered copy (the
    device analogue of ``add_correlated_events`` with ``to_add = N``), and
    the doubled stream is re-sorted by time on the device.

    Returns ``(xs', ys', ts', ps', mask')``, each of length ``2N``, with
    pad slots (mask 0) sorted to the tail. Host (numpy) stamps come back
    as float64 numpy with their origin restored (see ``_f32_time_offset``);
    the rest are f32 tensors.

    ``sort=False`` concatenates instead (every masked scatter is
    order-independent). The sort is one stable global sort on the masked
    keys with a gather per field (``ops.sort.time_sort``), whatever
    ``sort_block`` says: JAX's ``'auto'``, a pinned block and ``None`` all
    give that sort's stream, and so does JAX's packed word (integer
    coordinates) on the inputs it holds. On inputs it does not hold
    (coordinates outside [0, 2^14), a polarity other than +-1, a mask
    other than 0 or 1) JAX's packed word corrupts the stream; here integer
    and float coordinates give the same stream. Pad slots keep their stamp
    (JAX's packed path reads them back as the origin).
    """
    dev = _draw_device((xs, ys, ts, ps, mask), device, generator)
    zx, zy, zt = _normal((3, len(ts)), generator, dev)
    return _densify_core(xs, ys, ts, ps, mask, zx, zy, zt, xy_std=xy_std,
                         ts_std=ts_std, sensor_resolution=sensor_resolution,
                         sort=sort, sort_block=sort_block, device=dev)


def _remove_mask_core(scores, to_remove: int):
    """Keep-mask dropping the ``to_remove`` lowest ``scores`` (all of them
    for ``to_remove >= n``)."""
    n = scores.shape[0]
    if to_remove >= n:
        return torch.zeros((n,), dtype=torch.bool, device=scores.device)
    thresh = torch.sort(scores).values[to_remove]
    return scores >= thresh


def remove_events_mask_torch(n: int, to_remove: int, generator=None,
                             device=None):
    """Random keep-mask over a fixed-capacity batch: the device analogue of
    ``remove_events`` (drops exactly ``to_remove`` of ``n`` slots). The
    scores are float64 draws, so that no two tie at the threshold."""
    dev = _draw_device((), device, generator)
    scores = torch.rand((n,), generator=generator, device=dev,
                        dtype=torch.float64)
    return _remove_mask_core(scores, to_remove)
