"""3-D spatiotemporal event rendering (matplotlib).

Port of ``event_utils_tpu.visualization.draw_event_stream``, a rebuild of
reference ``lib/visualization/draw_event_stream.py``: ortho-projected
scatter of (x, t, y) colored by polarity, frames as textured surfaces at
their timestamps, a compressed black "structure" layer, voxel renders, and
sliding-window / between-frames video renderers.

``matplotlib`` is imported only inside the functions that draw (the card's
machine has none). The structure layer and the voxel renders come from the
port's representations, on ``device`` (default the card; ``device="cpu"``
for the plain versions); every array handed to matplotlib is numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..representations.image import events_to_image
from ..representations.voxel_grid import events_to_voxel
from .._device import to_numpy
from ..utils.event_util import clip_events_to_bounds
from ..utils.util import ensure_dir
from .visualization_utils import crop_to_size, parse_crop

POS_COLOR = "r"
NEG_COLOR = "b"
NEG_COLOR_INVERT = "#00DAFF"


def _block_reduce_mean(vox, block):
    """Mean-pool a (B, H, W) grid by integer block sizes (replaces
    skimage.measure.block_reduce)."""
    b, h, w = vox.shape
    bb, bh, bw = block
    ph, pw = (-h) % bh, (-w) % bw
    vox = np.pad(vox, ((0, 0), (0, ph), (0, pw)))
    vox = vox.reshape(b // bb if bb > 1 else b, bb if bb > 1 else 1,
                      vox.shape[1] // bh, bh, vox.shape[2] // bw, bw)
    return vox.mean(axis=(1, 3, 5))


def plot_events(xs, ys, ts, ps, save_path=None, num_compress="auto",
                num_show: int = 1000, event_size: float = 2, elev: float = 0,
                azim: float = 45, imgs=(), img_ts=(), show_events: bool = True,
                show_frames: bool = True, show_plot: bool = False, crop=None,
                compress_front: bool = False, marker: str = ".",
                stride: int = 1, invert: bool = False, img_size=None,
                show_axes: bool = False, dpi: int = 600, ax=None,
                device=None):
    """Render events in a spatiotemporal volume
    (reference draw_event_stream.py:152-276).

    Polarity colors are red / blue (cyan on inverted backgrounds); frames are
    drawn as textured planes at their timestamps with the local event
    structure blended into the green channel; ``num_compress`` early events
    are drawn black at one end of the volume as a spatial anchor.
    """
    import matplotlib.pyplot as plt

    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    imgs = list(imgs)
    img_ts = list(np.atleast_1d(np.asarray(img_ts))) if len(imgs) else []
    if img_size is None:
        img_size = ([int(ys.max()) + 1, int(xs.max()) + 1] if not imgs
                    else imgs[0].shape[0:2])
    crop = [0, img_size[0], 0, img_size[1]] if crop is None else crop
    xs, ys, ts, ps = clip_events_to_bounds(xs, ys, ts, ps, crop)
    xs, ys = xs - crop[2], ys - crop[0]
    if len(xs) == 0:
        return None

    num_show = len(xs) if num_show == -1 else num_show
    skip = max(len(xs) // max(num_show, 1), 1)
    if num_compress in ("auto",):
        num_compress = min(int(img_size[0] * img_size[1] * 0.5), len(xs))
    elif num_compress in ("all", -1):
        num_compress = len(xs)
    xs, ys, ts, ps = xs[::skip], ys[::skip], ts[::skip], ps[::skip]

    own_fig = ax is None
    if own_fig:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d", proj_type="ortho")
    colors = np.where(ps > 0, POS_COLOR,
                      NEG_COLOR_INVERT if invert else NEG_COLOR)

    if imgs and show_frames:
        # ONE scatter for the whole cloud (a per-frame scatter would draw
        # every event len(imgs) times — visibly darker points and N-fold
        # render time; mpl's 3-D axes don't z-sort across artists anyway,
        # so per-frame before/after splits buy no occlusion ordering)
        if show_events and len(xs):
            ax.scatter(xs, ts, ys, zdir="z", c=colors, s=event_size,
                       marker=marker, linewidths=0)
        for img, t_img in zip(imgs, img_ts):
            img = np.asarray(img, float)[crop[0]:crop[1], crop[2]:crop[3]]
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=2)
            if img.max() > 1.0:
                img = img / 255.0
            if num_compress > 0:
                structure = to_numpy(events_to_image(
                    xs[:num_compress], ys[:num_compress],
                    np.ones(min(num_compress, len(xs))),
                    sensor_size=img.shape[0:2], device=device))
                img[:, :, 1] = np.clip(img[:, :, 1] + (structure > 0), 0, 1)
            gy, gx = np.ogrid[0:img.shape[0], 0:img.shape[1]]
            ax.plot_surface(gx, np.full_like(gx, t_img, dtype=float), gy,
                            rstride=stride, cstride=stride, facecolors=img)
    else:
        if show_events:
            ax.scatter(xs, ts, ys, zdir="z", c=colors, s=event_size,
                       marker=marker, linewidths=0)
        if num_compress > 0:
            k = min(num_compress, len(xs))
            anchor_t = ts[-1] if compress_front else ts[0]
            sel = slice(-k, None) if compress_front else slice(0, k)
            ax.scatter(xs[sel], np.full(k, anchor_t), ys[sel], zdir="z",
                       c="w" if invert else "k", s=event_size, marker=marker)

    ax.view_init(elev=elev, azim=azim)
    ax.grid(False)
    for pane in (ax.xaxis.pane, ax.yaxis.pane, ax.zaxis.pane):
        pane.fill = False
    if not show_axes:
        for axis in (ax.xaxis, ax.yaxis, ax.zaxis):
            axis.line.set_color((1.0, 1.0, 1.0, 0.0))
        if callable(getattr(ax, "set_frame_on", None)):
            ax.set_frame_on(False)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zticks([])
    ax.set_xlim3d(0, crop_to_size(crop)[1])
    ax.set_ylim3d(float(ts[0]), float(ts[-1]))
    ax.set_zlim3d(0, crop_to_size(crop)[0])

    if show_plot:
        plt.show()
    if save_path is not None:
        ensure_dir(os.path.dirname(save_path) or ".")
        plt.savefig(save_path, transparent=True, dpi=dpi, bbox_inches="tight")
    if own_fig:
        plt.close()
    return ax


def plot_voxel_grid(xs, ys, ts, ps, bins: int = 5, frames=(), frame_ts=(),
                    sensor_size=None, crop=None, elev: float = 0,
                    azim: float = 45, show_axes: bool = False,
                    save_path=None, show_plot: bool = True,
                    downsample: int = 10, max_events: int = 10000,
                    device=None):
    """Render a voxel grid as 3-D cubes, red/blue by accumulated polarity
    (reference draw_event_stream.py:75-150); grids are mean-pooled by
    ``downsample`` so the cube count stays tractable."""
    import matplotlib.pyplot as plt

    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    if sensor_size is None:
        sensor_size = ([int(ys.max()) + 1, int(xs.max()) + 1]
                       if not len(frames) else frames[0].shape[:2])
    if crop is not None:
        xs, ys, ts, ps = clip_events_to_bounds(xs, ys, ts, ps, crop)
        sensor_size = crop_to_size(crop)
        xs, ys = xs - crop[2], ys - crop[0]
    xs, ys, ts, ps = xs[:max_events], ys[:max_events], ts[:max_events], ps[:max_events]
    if len(xs) == 0:
        return None

    vox = to_numpy(events_to_voxel(xs, ys, ts, ps, bins,
                                   sensor_size=sensor_size, device=device))
    vox = _block_reduce_mean(vox, (1, downsample, downsample))
    # pad the bin axis so the volume renders roughly cubic
    dimdiff = max(vox.shape[1] - vox.shape[0], 0)
    vox = np.concatenate([np.zeros((dimdiff, *vox.shape[1:])), vox], axis=0)
    vox = vox.transpose(0, 2, 1)

    filled = vox != 0
    pmax = max(vox.max(), 1e-9)
    nmax = max(-vox.min(), 1e-9)
    frac_p = np.clip(vox / pmax, 0, 1) * 0.5 + 0.5
    frac_n = np.clip(-vox / nmax, 0, 1) * 0.5 + 0.5
    colors = np.zeros(vox.shape + (4,))
    pos = vox > 0
    neg = vox < 0
    colors[pos] = np.stack([frac_p[pos], np.zeros_like(frac_p[pos]),
                            frac_p[pos] - 0.5, np.ones_like(frac_p[pos])], -1)
    colors[neg] = np.stack([frac_n[neg] - 0.5, np.zeros_like(frac_n[neg]),
                            frac_n[neg], np.ones_like(frac_n[neg])], -1)

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d", proj_type="ortho")
    ax.voxels(filled, facecolors=colors)
    ax.view_init(elev=elev, azim=azim)
    if not show_axes:
        ax.set_axis_off()
    if save_path is not None:
        ensure_dir(os.path.dirname(save_path) or ".")
        plt.savefig(save_path, transparent=True, dpi=300, bbox_inches="tight")
    if show_plot:
        plt.show()
    plt.close()
    return vox


def plot_events_sliding(xs, ys, ts, ps, args, dt=None, sdt=None, frames=(),
                        frame_ts=()):
    """Sliding-window video rendering with an animated camera ramp
    (reference draw_event_stream.py:15-73). ``args`` carries the
    ``plot_events`` options (see ``cli.visualize_events``); explicit
    ``dt``/``sdt`` override ``args.w_width``/``args.sw_width`` (same
    signature as the mayavi twin, so the CLI can call either renderer).
    ``args.device``, where the namespace has one, is where the
    representations run."""
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    dt = args.w_width if dt is None else dt
    sdt = args.sw_width if sdt is None else sdt
    if dt is None:
        dt = (ts[-1] - ts[0]) / 10
        sdt = dt / 10
    if sdt is None:  # window width given but stride not: advance one window
        sdt = dt

    frames = list(frames)
    if frames:
        sensor_size = frames[0].shape
        frame_ts = np.asarray(frame_ts)
        if frame_ts.ndim == 2:
            frame_ts = frame_ts[:, 1]
    else:
        sensor_size = [int(ys.max()) + 1, int(xs.max()) + 1]

    starts = np.arange(ts[0], ts[-1] - dt, sdt)
    n_frames = len(starts)
    for i, t0 in enumerate(starts):
        te = t0 + dt
        e0, e1 = np.searchsorted(ts, (t0, te))
        wxs, wys, wts, wps = xs[e0:e1], ys[e0:e1], ts[e0:e1], ps[e0:e1]
        wframes, wframe_ts = [], []
        if frames:
            f0 = int(np.searchsorted(frame_ts, t0))
            f0 = min(f0, len(frames) - 1)
            wframes = [frames[f0]]
            wframe_ts = [wts[0] if len(wts) else t0]

        # camera ramp between 20% and 70% of the sweep (reference :58-67)
        perc = i / max(n_frames, 1)
        min_p, max_p = 0.2, 0.7
        elev, azim = args.elev, args.azim
        max_elev, max_azim = 10, 45
        if min_p < perc < max_p:
            p_way = (perc - min_p) / (max_p - min_p)
            elev = elev + max_elev * p_way
            azim = azim - max_azim * p_way
        elif perc >= max_p:
            elev, azim = max_elev, max_azim

        save_path = os.path.join(args.output_path, f"frame_{i:010d}.jpg")
        plot_events(wxs, wys, wts, wps, save_path=save_path,
                    num_show=args.num_show, event_size=args.event_size,
                    imgs=wframes, img_ts=wframe_ts,
                    show_events=not args.hide_events, azim=azim, elev=elev,
                    show_frames=not args.hide_frames, crop=args.crop,
                    compress_front=args.compress_front, invert=args.invert,
                    num_compress=args.num_compress, show_plot=args.show_plot,
                    img_size=sensor_size[:2], show_axes=args.show_axes,
                    stride=args.stride, device=getattr(args, "device", None))


def plot_between_frames(xs, ys, ts, ps, frames, frame_event_idx, args,
                        plttype: str = "voxel"):
    """Per-frame-interval rendering over a sequence
    (reference draw_event_stream.py:278-316). ``args.device``, where the
    namespace has one, is where the representations run."""
    args.crop = None if args.crop is None else parse_crop(args.crop)
    frame_event_idx = np.asarray(frame_event_idx)
    for i in range(0, len(frames), args.skip_frames):
        if args.hide_skipped:
            frame = [frames[i]]
            frame_indices = frame_event_idx[i][np.newaxis, ...]
        else:
            frame = frames[i:i + args.skip_frames]
            frame_indices = frame_event_idx[i:i + args.skip_frames]
        # canonical (start, end) rows (cli/visualize_events.py builds
        # them via frame_event_indices): full span = first start..last end
        s, e = int(frame_indices[0, 0]), int(frame_indices[-1, 1])
        if e <= s:
            continue
        # the end index is EXCLUSIVE (can equal len(ts)); the frame's
        # timestamp is the last event inside its interval
        img_ts = [ts[min(max(int(f[1]) - 1, 0), len(ts) - 1)]
                  for f in frame_indices]
        fname = os.path.join(args.output_path, f"events_{i:09d}.png")
        if plttype == "voxel":
            plot_voxel_grid(xs[s:e], ys[s:e], ts[s:e], ps[s:e],
                            bins=args.num_bins, crop=args.crop, frames=frame,
                            frame_ts=img_ts, elev=args.elev, azim=args.azim,
                            save_path=fname, show_plot=args.show_plot,
                            device=getattr(args, "device", None))
        elif plttype == "events":
            plot_events(xs[s:e], ys[s:e], ts[s:e], ps[s:e], save_path=fname,
                        num_show=args.num_show, event_size=args.event_size,
                        imgs=frame, img_ts=img_ts,
                        show_events=not args.hide_events, azim=args.azim,
                        elev=args.elev, show_frames=not args.hide_frames,
                        crop=args.crop, compress_front=args.compress_front,
                        invert=args.invert, num_compress=args.num_compress,
                        show_plot=args.show_plot, stride=args.stride,
                        device=getattr(args, "device", None))
