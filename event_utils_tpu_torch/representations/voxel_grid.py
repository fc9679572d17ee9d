"""Temporally-bilinear voxel grids (port of
``event_utils_tpu.representations.voxel_grid``).

Each event adds ``ps * max(0, 1-|t_norm-b|)`` to the (at most) two bins
bracketing it, in one flattened ``B*H*W`` scatter. Spatial accumulation
truncates coordinates to integers, as the reference's torch path does;
``spatial_interpolation='bilinear'`` splats 4 spatial taps instead.

``impl='matmul*'`` (with the default temporal-bilinear, integer-coordinate
route) runs the hand-written CUDA voxel kernel (``ops.cuda_scatter``) for
every sensor size. ``impl='tiled'`` and ``events_to_voxel_tiled`` bucket
the events by sensor tile on the host and run the per-tile CUDA kernel
(``voxel_matmul_tiles``). Where the JAX package vmaps ``events_to_voxel``
over rows of events (``voxel_grids_fixed_n``, the trainers' padded
batches), ``events_to_voxel_rows`` builds every row's grid in one call:
the batched voxel kernel (``voxel_matmul_batched``) under ``'matmul*'``,
one flat scatter with ids offset by row otherwise.

By design the port's ``impl='matmul'`` does not auto-route large sensors to
the tiled route as the JAX package does (its one-hot kernel runs out of
VMEM there): the card's voxel kernel has no such limit, and neither has the
tiled kernel, so no ``SensorLimitError`` is raised for a large tile.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import as_f32, as_tensor, pick_device, to_numpy
from ..errors import ConfigurationError
from ..ops.cuda_scatter import (voxel_matmul, voxel_matmul_batched,
                                 voxel_matmul_tiles)
from ..ops.scatter import bilinear_scatter, scatter_add_2d, scatter_add_flat

_PRECISION = {"matmul": "hilo", "matmul_hilo": "hilo",
              "matmul_bf16": "bf16", "matmul_int8": "int8"}

# Spatial tile of the tiled voxel route (the JAX package's DEFAULT_TILE).
DEFAULT_TILE = (96, 128)


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
    if impl == "tiled":
        # explicit large-sensor route: the events are bucketed on the host
        # first, so they go to the device once, bucketed (floats in f32 as
        # on every other route)
        if not (temporal_bilinear and spatial_interpolation is None
                and mask is None and t0 is None and t1 is None):
            raise ConfigurationError(
                "impl='tiled' supports only the default temporal-bilinear "
                "integer-coordinate path with no mask/t0/t1 overrides "
                "(host-side bucketing; call events_to_voxel_tiled directly "
                "for tile/capacity control)")
        xs, ys = (a.astype(np.float32)
                  if np.issubdtype(a.dtype, np.floating) else a
                  for a in map(to_numpy, (xs, ys)))
        ts, ps = (to_numpy(a).astype(np.float32) for a in (ts, ps))
        return events_to_voxel_tiled(xs, ys, ts, ps, B, sensor_size,
                                     device=dev)
    xs = as_tensor(xs, dev)
    ys = as_tensor(ys, dev)
    ts = as_f32(ts, dev)
    ps = as_f32(ps, dev)
    if mask is not None:
        mask = as_tensor(mask, dev)

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


def events_to_voxel_tiled(xs, ys, ts, ps, B: int, sensor_size,
                          tile=DEFAULT_TILE, impl: str = "matmul",
                          capacity=None, device=None) -> torch.Tensor:
    """Voxel grid through spatial tiles (``events_to_voxel_tiled``, JAX
    ``voxel_grid.py:187-248``).

    Events are bucketed by sensor tile on the host
    (``bucket_events_by_roi``, time order kept within each tile), then ONE
    launch of the per-tile CUDA kernel (``voxel_matmul_tiles``) accumulates
    every tile over the stream's window ``[ts[0], ts[-1]]`` and the tiles
    are stitched. Events must be time-sorted, as for every voxel route.
    Forward only. A ``capacity`` that would drop events in the densest
    tile raises ``ConfigurationError`` (an accumulating representation
    never subsamples). Returns ``(B, H, W)``.
    """
    from ..contrast_max.events_cmax import bucket_events_by_roi

    dev = pick_device(xs, ys, ts, ps, device=device)
    H, W = sensor_size
    th, tw = tile
    ny = (H + th - 1) // th
    nx = (W + tw - 1) // tw
    ts = to_numpy(ts).astype(np.float64)
    t0 = float(ts[0]) if len(ts) else 0.0
    t1 = float(ts[-1]) if len(ts) else 1.0
    bx, by, bt, bp, bmask, origins, overflow = bucket_events_by_roi(
        xs, ys, ts, ps, (ny * th, nx * tw), tile, capacity=capacity,
        capacity_cap=None, device=dev)
    if overflow:
        raise ConfigurationError(
            f"events_to_voxel_tiled: capacity={capacity} drops {overflow} "
            "events in the densest tile; pass capacity=None (auto) or a "
            "larger value")
    ox = origins[:, 1:2].to(torch.int32)   # (T, 1) broadcast
    oy = origins[:, 0:1].to(torch.int32)
    tiles = voxel_matmul_tiles(
        bx.to(torch.int32) - ox, by.to(torch.int32) - oy, bt, bp, B, tile,
        np.float32(t0), np.float32(t1), mask=bmask,
        precision=_PRECISION.get(impl, "hilo"))
    # stitch (ny*nx, B, th, tw) -> (B, ny*th, nx*tw) -> crop to (B, H, W)
    grid = tiles.reshape(ny, nx, B, th, tw).permute(2, 0, 3, 1, 4)
    return grid.reshape(B, ny * th, nx * tw)[:, :H, :W]


def events_to_voxel_torch(xs, ys, ts, ps, B, device=None,
                          sensor_size=(180, 240), temporal_bilinear=True,
                          **kw):
    """Signature-compatible alias of the reference's torch entry point
    (voxel_grid.py:114: ``events_to_voxel_torch(xs, ys, ts, ps, B, device,
    ...)``); here ``device`` is where the grid is built."""
    return events_to_voxel(xs, ys, ts, ps, B, sensor_size=sensor_size,
                           temporal_bilinear=temporal_bilinear,
                           device=device, **kw)


def events_to_neg_pos_voxel(xs, ys, ts, ps, B: int, sensor_size=(180, 240),
                            temporal_bilinear: bool = True, mask=None,
                            impl: Optional[str] = None, device=None):
    """Polarity-split voxel grids (reference voxel_grid.py:155-182).

    Positive events are ``ps > 0``, negative ``ps <= 0`` (the torch
    reference's convention). Returns ``(voxel_pos, voxel_neg)``.
    """
    dev = pick_device(xs, ys, ts, ps, mask, device=device)
    ps = as_f32(ps, dev)
    pos_w = (ps > 0).to(torch.float32)
    neg_w = (ps <= 0).to(torch.float32)
    kw = dict(sensor_size=sensor_size, temporal_bilinear=temporal_bilinear,
              mask=mask, impl=impl, device=dev)
    return (events_to_voxel(xs, ys, ts, pos_w, B, **kw),
            events_to_voxel(xs, ys, ts, neg_w, B, **kw))


def events_to_neg_pos_voxel_torch(xs, ys, ts, ps, B, device=None, **kw):
    return events_to_neg_pos_voxel(xs, ys, ts, ps, B, device=device, **kw)


def segment_windows(ts, seg, num_segments: int):
    """Each segment's first and last stamp, ``(num_segments,)`` each, for
    events in any order: the min and max of the stamps of its events (one
    ``scatter_reduce`` each; float32 max and -max for an empty segment).
    ``seg`` as ``events_to_voxel_segments`` takes it. A caller that knows
    its events' order reads them off that order instead
    (``training.in_the_loop`` does)."""
    seg = seg.long()
    live = (seg >= 0) & (seg < num_segments)
    sid = torch.where(live, seg, 0)
    ts = ts.to(torch.float32)
    big = torch.finfo(torch.float32).max
    t0 = torch.full((num_segments,), big, device=ts.device).scatter_reduce(
        0, sid, torch.where(live, ts, big), "amin")
    t1 = torch.full((num_segments,), -big, device=ts.device).scatter_reduce(
        0, sid, torch.where(live, ts, -big), "amax")
    return t0, t1


def events_to_voxel_segments(xs, ys, ts, ps, seg, num_segments: int,
                             B: int, sensor_size=(180, 240),
                             impl: Optional[str] = None, t0=None,
                             t1=None) -> torch.Tensor:
    """Voxel grids of many windows in ONE flat scatter:
    ``(num_segments, B, H, W)``.

    ``seg`` gives each event its window (-1 or ``num_segments`` and above
    drop it). Each window's grid is what ``events_to_voxel`` (temporally
    bilinear, integer coordinates) gives on that window's events alone:
    its ``[t0, t1]`` is the first and last stamp among them, given per
    segment (both ``t0`` and ``t1``, ``(num_segments,)`` tensors) or taken
    by ``segment_windows``.
    Ids are offset by ``seg * B*H*W``, so the T x B windows of the E2VID
    batches take one scatter (one flat-kernel launch under ``'pallas'``)
    where the JAX package vmaps one per window. All inputs are tensors on
    one device.
    """
    H, W = sensor_size
    seg = seg.long()
    live = (seg >= 0) & (seg < num_segments)
    sid = torch.where(live, seg, 0)
    ts = ts.to(torch.float32)
    if t0 is None or t1 is None:
        t0, t1 = segment_windows(ts, seg, num_segments)
    t0, t1 = t0[sid], t1[sid]
    dt = t1 - t0
    dt = torch.where(dt == 0, 1.0, dt)
    ixs = torch.trunc(xs.to(torch.float32)).long()
    iys = torch.trunc(ys.to(torch.float32)).long()
    ok_px = live & (ixs >= 0) & (ixs < W) & (iys >= 0) & (iys < H)
    t_norm = (ts - t0) / dt * (B - 1)
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    ib0 = torch.where(torch.isfinite(b0), b0, -1.0).long()
    base = sid * (B * H * W) + iys * W + ixs
    ids, ws = [], []
    for ib, wb in ((ib0, 1.0 - fb), (ib0 + 1, fb)):
        ok = ok_px & (ib >= 0) & (ib < B)
        ids.append(torch.where(ok, base + ib * (H * W), -1))
        ws.append(ps.to(torch.float32) * wb)
    flat = scatter_add_flat(torch.cat(ids), torch.cat(ws),
                            num_segments * B * H * W, impl=impl)
    return flat.view(num_segments, B, H, W)


def events_to_neg_pos_voxel_segments(xs, ys, ts, ps, seg, num_segments: int,
                                     B: int, sensor_size=(180, 240),
                                     combined: bool = False,
                                     impl: Optional[str] = None, t0=None,
                                     t1=None) -> torch.Tensor:
    """``events_to_voxel_segments`` split by polarity into the trainers'
    channel layout: ``(num_segments, 2B, H, W)``, positive (``ps > 0``)
    bins first, then negative (``ps <= 0``), as
    ``events_to_neg_pos_voxel`` and a concatenation give; two scatters over
    one per-segment window, taken once (``t0``/``t1`` when given).
    ``combined``: one ``(num_segments, B, H, W)`` grid of ``ps``."""
    if t0 is None or t1 is None:
        t0, t1 = segment_windows(ts, seg, num_segments)
    kw = dict(sensor_size=sensor_size, impl=impl, t0=t0, t1=t1)
    if combined:
        return events_to_voxel_segments(xs, ys, ts, ps, seg, num_segments, B,
                                        **kw)
    return torch.cat([events_to_voxel_segments(
        xs, ys, ts, sel.to(torch.float32), seg, num_segments, B, **kw)
        for sel in (ps > 0, ps <= 0)], 1)


def events_to_voxel_rows(xs, ys, ts, ps, B: int, sensor_size=(180, 240),
                         temporal_bilinear: bool = True, mask=None,
                         split: bool = False,
                         impl: Optional[str] = None) -> torch.Tensor:
    """Voxel grids of S rows of events in one call, as JAX's ``jax.vmap``
    of ``events_to_voxel`` builds them: ``(S, B, H, W)``, grid s what
    ``events_to_voxel`` gives on row s (with ``mask[s]``): its window is
    the row's first and last valid stamp. ``split``: ``(S, 2B, H, W)``,
    each row's ``events_to_neg_pos_voxel`` grids one after the other.

    ``xs``, ``ys``, ``ts``, ``ps`` and ``mask`` are ``(S, N)`` tensors on one
    device. Under ``impl='matmul*'`` (temporally bilinear) one batched
    voxel kernel launch per chunk of rows (``voxel_matmul_batched``); every
    other ``impl`` takes the exact route, one flat scatter
    (``scatter_add_flat``: ``index_add_`` under 'xla') with ids offset by
    the row's (and polarity's) grid.
    """
    H, W = sensor_size
    if impl in _PRECISION and temporal_bilinear:
        return voxel_matmul_batched(xs, ys, ts, ps, B, sensor_size=sensor_size,
                                    precision=_PRECISION[impl], mask=mask,
                                    split=split)
    # the slice binning's matmul routes are the flat kernel, as
    # scatter_add_2d's are
    flat_impl = "pallas" if impl in _PRECISION else impl
    S = xs.shape[0]
    dev = xs.device
    ts = ts.to(torch.float32)
    ps = ps.to(torch.float32)
    if mask is None:
        t0, t1 = ts[:, :1], ts[:, -1:]
    else:
        big = torch.finfo(torch.float32).max
        t0 = torch.where(mask != 0, ts, big).amin(1, keepdim=True)
        t1 = torch.where(mask != 0, ts, -big).amax(1, keepdim=True)
    dt = t1 - t0
    dt = torch.where(dt == 0, 1.0, dt)
    grid = torch.arange(S, device=dev)[:, None]
    if split:
        grid = 2 * grid + (ps <= 0).long()
        ps = torch.ones_like(ps)
    if mask is not None:
        ps = ps * mask.to(ps.dtype)
    ixs = torch.trunc(xs.to(torch.float32)).long()
    iys = torch.trunc(ys.to(torch.float32)).long()
    in_img = (ixs >= 0) & (ixs < W) & (iys >= 0) & (iys < H)
    base = grid * (B * H * W) + iys * W + ixs
    buckets = S * (2 if split else 1) * B * H * W
    if temporal_bilinear:
        t_norm = (ts - t0) / dt * (B - 1)
        b0 = torch.floor(t_norm)
        fb = t_norm - b0
        ib0 = torch.where(torch.isfinite(b0), b0, -1.0).long()
        ids, ws = [], []
        for ib, wb in ((ib0, 1.0 - fb), (ib0 + 1, fb)):
            ok = in_img & (ib >= 0) & (ib < B)
            ids.append(torch.where(ok, base + ib * (H * W), -1).reshape(-1))
            ws.append((ps * wb).reshape(-1))
        flat = scatter_add_flat(torch.cat(ids), torch.cat(ws), buckets,
                                impl=flat_impl)
    else:
        # equal-duration slice binning; the int cast truncates
        bin_idx = ((ts - t0) / dt * B).to(torch.int32).long().clamp(0, B - 1)
        ids = torch.where(in_img, base + bin_idx * (H * W), -1)
        flat = scatter_add_flat(ids.reshape(-1), ps.reshape(-1), buckets,
                                impl=flat_impl)
    return flat.view(S, -1, H, W)


def events_to_voxel_timesync(xs, ys, ts, ps, B: int, t0, t1, np_ts=None,
                             sensor_size=(180, 240),
                             temporal_bilinear: bool = True,
                             impl: Optional[str] = None,
                             device=None) -> torch.Tensor:
    """Voxel of the events between ``t0`` and ``t1`` (reference
    voxel_grid.py:82-112): a host-side ``searchsorted`` slice, then one
    ``events_to_voxel``."""
    if not t1 > t0:
        raise ConfigurationError(f"need t1 > t0, got t0={t0}, t1={t1}")
    np_ts = to_numpy(ts) if np_ts is None else np_ts
    start = int(np.searchsorted(np_ts, t0))
    end = int(np.searchsorted(np_ts, t1))
    if not start < end:
        raise ConfigurationError(f"no events in [{t0}, {t1})")
    return events_to_voxel(xs[start:end], ys[start:end], ts[start:end],
                           ps[start:end], B, sensor_size=sensor_size,
                           temporal_bilinear=temporal_bilinear, impl=impl,
                           device=device)


events_to_voxel_timesync_torch = events_to_voxel_timesync


def voxel_grids_fixed_n(xs, ys, ts, ps, B: int, n: int,
                        sensor_size=(180, 240), temporal_bilinear: bool = True,
                        impl: Optional[str] = None, device=None):
    """Voxel grids over consecutive windows of ``n`` events (reference
    voxel_grid.py:37-57). The stream is cut to ``(num_windows, n)`` rows and
    every window is built in one call (``events_to_voxel_rows``), as the
    JAX package's ``jax.vmap`` builds them: under ``impl='matmul*'`` one
    batched voxel kernel launch per chunk of windows, otherwise one flat
    scatter with ids offset by window. ``impl='tiled'`` raises
    ``ConfigurationError``: its host bucketing needs one concrete stream, and
    JAX's vmapped call raises too. Returns ``(num_windows, B, H, W)``."""
    if impl == "tiled":
        raise ConfigurationError(
            "voxel_grids_fixed_n: impl='tiled' buckets one stream on the "
            "host and does not batch windows; use impl='matmul'")
    dev = pick_device(xs, ys, ts, ps, device=device)
    num = (len(xs) - n) // n + 1 if len(xs) >= n else 0
    if num <= 0:
        return torch.zeros((0, B) + tuple(sensor_size), device=dev)
    cut = num * n
    xs, ys = (as_tensor(a[:cut], dev).reshape(num, n) for a in (xs, ys))
    ts, ps = (as_f32(a[:cut], dev).reshape(num, n) for a in (ts, ps))
    return events_to_voxel_rows(xs, ys, ts, ps, B, sensor_size=sensor_size,
                                temporal_bilinear=temporal_bilinear,
                                impl=impl)


voxel_grids_fixed_n_torch = voxel_grids_fixed_n


def voxel_grids_fixed_t(xs, ys, ts, ps, B: int, t: float,
                        sensor_size=(180, 240), temporal_bilinear: bool = True,
                        impl: Optional[str] = None, device=None):
    """Voxel grids over fixed-duration windows (reference
    voxel_grid.py:59-80). Returns a list (windows are ragged)."""
    np_ts = to_numpy(ts)
    return [events_to_voxel_timesync(
        xs, ys, ts, ps, B, t_start, t_start + t, np_ts=np_ts,
        sensor_size=sensor_size, temporal_bilinear=temporal_bilinear,
        impl=impl, device=device)
        for t_start in np.arange(np_ts[0], np_ts[-1] - t, t)]


voxel_grids_fixed_t_torch = voxel_grids_fixed_t


def get_voxel_grid_as_image(voxelgrid, normalize: bool = True):
    """Bins side by side as one debug image (reference voxel_grid.py:9-24).
    Host numpy."""
    vg = to_numpy(voxelgrid)
    splitter = np.ones((vg.shape[1], 2)) * vg.max()
    parts = []
    for image in vg:
        parts.append(image)
        parts.append(splitter)
    parts.pop()
    sidebyside = np.hstack(parts)
    if normalize:
        mn, mx = sidebyside.min(), sidebyside.max()
        sidebyside = (sidebyside - mn) / max(mx - mn, 1e-12) * 255.0
    return sidebyside


def plot_voxel_grid(voxelgrid, cmap="gray", show: bool = True):
    """Display a voxel grid as side-by-side bins (reference
    voxel_grid.py:26-35). Imports matplotlib when called."""
    import matplotlib.pyplot as plt
    sidebyside = get_voxel_grid_as_image(voxelgrid)
    plt.imshow(sidebyside, cmap=cmap)
    if show:
        plt.show()
    return sidebyside
