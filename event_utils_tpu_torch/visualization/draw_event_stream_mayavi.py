"""Mayavi twin of the 3-D event renderers (port of
``event_utils_tpu.visualization.draw_event_stream_mayavi``; reference
lib/visualization/draw_event_stream_mayavi.py:17-262).

- sphere-glyph event clouds coloured by polarity via a scalar LUT
  (``plot_events``, reference :160-230), with ``ts_scale`` temporal
  stretching, frame planes (``mlab.imshow``) inside the volume, crop,
  ``num_compress`` structure layers, and the reference's camera preset;
- sliding-window video with dummy-event head padding
  (``plot_events_sliding``, reference :17-101);
- between-frames video (``plot_between_frames``, reference :233-262);
- ``plot_voxel_grid`` stays matplotlib, as in the reference file (its
  mayavi module renders voxels with matplotlib too).

Mayavi is imported per call: every renderer raises an ImportError naming
the matplotlib twins (same API, ``draw_event_stream``) where it is
missing, as on the card's machine. The window and padding arithmetic is in
plain numpy helpers (``pad_sliding_head``, ``sliding_windows``,
``event_colors_lut``), tested without a GL stack.
"""

from __future__ import annotations

import os

import numpy as np

from .visualization_utils import ensure_dir, parse_crop


def available() -> bool:
    try:
        import mayavi  # noqa: F401
        return True
    except ImportError:
        return False


def _require_mlab():
    try:
        from mayavi import mlab
        return mlab
    except ImportError as exc:
        raise ImportError(
            "mayavi is not installed in this environment; use the matplotlib "
            "renderers in event_utils_tpu_torch.visualization."
            "draw_event_stream (same API) or install mayavi for interactive "
            "GL rendering."
        ) from exc


# ---------------------------------------------------------------------------
# Renderer-independent math (testable without mayavi)
# ---------------------------------------------------------------------------

def pad_sliding_head(xs, ys, ts, ps, frame_ts, dt, sdt):
    """Dummy-event head padding of the sliding video
    (reference draw_event_stream_mayavi.py:21-40): prepend zero events on a
    ``sdt`` grid covering one full window before the stream so the first
    video frames sweep into the data, then re-zero the time origin."""
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    head = np.arange(ts[0] - dt, ts[0], sdt)
    xs = np.concatenate((np.zeros(len(head)), xs))
    ys = np.concatenate((np.zeros(len(head)), ys))
    ps = np.concatenate((np.zeros(len(head)), ps))
    ts = np.concatenate((head, ts))
    shift = -ts[0]
    ts = ts + shift
    frame_ts = np.asarray(frame_ts, dtype=np.float64) + shift
    return xs, ys, ts, ps, frame_ts


def sliding_windows(ts, frame_ts, dt, sdt):
    """(event slice, frame slice) index pairs of each video frame
    (reference draw_event_stream_mayavi.py:66-81)."""
    out = []
    for t0 in np.arange(ts[0], ts[-1] - dt, sdt):
        te = t0 + dt
        eidx = (int(np.searchsorted(ts, t0)), int(np.searchsorted(ts, te)))
        fidx = (int(np.searchsorted(frame_ts, t0)),
                int(np.searchsorted(frame_ts, te)))
        out.append((eidx, fidx))
    return out


def event_colors_lut(ps):
    """Reference polarity coloring (draw_event_stream_mayavi.py:215-219):
    scalar 0 (red end of the LUT) for positive events, 240 (blue) for
    negative; zero-polarity padding events get glyph scale 0."""
    ps = np.asarray(ps)
    colors = np.where(ps > 0, 0, 240)
    ones = np.where(ps == 0, 0, 1)
    return colors, ones


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def _apply_camera_preset(mlab):
    """The reference's fixed camera pose (draw_event_stream_mayavi.py:44-51)."""
    engine = mlab.get_engine()
    scene = engine.scenes[0]
    scene.scene.camera.position = [373.12, 5353.96, 7350.07]
    scene.scene.camera.focal_point = [228.00, 37.75, 3421.44]
    scene.scene.camera.view_angle = 30.0
    scene.scene.camera.view_up = [0.99975, -0.02027, -0.00949]
    scene.scene.camera.clipping_range = [2400.25, 11907.42]
    scene.scene.camera.compute_view_plane_normal()


def plot_events(xs, ys, ts, ps, save_path=None, num_compress="auto",
                num_show: int = 1000, event_size: float = 2,
                elev: float = 0, azim: float = 45, imgs=(), img_ts=(),
                show_events: bool = True, show_frames: bool = True,
                show_plot: bool = False, crop=None,
                compress_front: bool = False, marker: str = "sphere",
                stride: int = 1, invert: bool = False, img_size=None,
                show_axes: bool = False, ts_scale: float = 100000.0,
                figure=None):
    """Sphere-glyph spatiotemporal render (reference
    draw_event_stream_mayavi.py:160-230): polarity-colored quiver3d sphere
    glyphs, frame planes at their (scaled) timestamps inside the volume,
    crop + subsampling + compress layers. Requires mayavi."""
    from ..utils.event_util import clip_events_to_bounds

    mlab = _require_mlab()
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    if img_size is None:
        img_size = ([int(ys.max()) + 1, int(xs.max()) + 1] if len(imgs) == 0
                    else np.asarray(imgs[0]).shape[0:2])
    cropbox = [0, img_size[0], 0, img_size[1]] if crop is None else crop
    xs, ys, ts, ps = clip_events_to_bounds(xs, ys, ts, ps, cropbox,
                                           set_zero=False)
    xs, ys = xs - cropbox[2], ys - cropbox[0]

    num_show = len(xs) if num_show == -1 else num_show
    skip = max(len(xs) // max(num_show, 1), 1)
    if num_compress == "auto":
        num_compress = int(min(img_size[0] * img_size[1] * 0.5, len(xs)))
    elif num_compress in ("all", -1):  # matplotlib-twin parity: 'all' too
        num_compress = len(xs)
    xs, ys, ts, ps = xs[::skip], ys[::skip], ts[::skip], ps[::skip]
    if len(xs) == 0:
        return None
    t0 = ts[0]
    t = (ts - t0) * ts_scale

    fig = figure or mlab.figure(bgcolor=(0, 0, 0) if invert else (1, 1, 1),
                                size=(1080, 720))

    # frame planes inside the volume (reference :211-213)
    if show_frames:
        for img, ti in zip(imgs, np.atleast_1d(np.asarray(img_ts))):
            img = np.asarray(img)[cropbox[0]:cropbox[1], cropbox[2]:cropbox[3]]
            z = (ti - t0) * ts_scale
            mlab.imshow(img, colormap="gray",
                        extent=[0, img.shape[0], 0, img.shape[1],
                                z, z + 0.01],
                        opacity=1.0, transparent=False, figure=fig)

    if show_events:
        # compress layer: oldest events flattened to one "structure" sheet
        # at the front/back of the volume (matplotlib twin's semantics)
        n_c = int(num_compress)
        if n_c > 0:
            # matplotlib-twin parity (draw_event_stream.py:115-118):
            # compress_front=False -> FIRST events sheeted at the start of
            # the time axis; True -> LAST events at the end
            cs = slice(-n_c, None) if compress_front else slice(0, n_c)
            zc = float(t[-1]) if compress_front else 0.0
            mlab.points3d(ys[cs], xs[cs], np.full(len(xs[cs]), zc),
                          mode="sphere", scale_factor=event_size,
                          color=(0, 0, 0), figure=fig)
        colors, ones = event_colors_lut(ps)
        p3d = mlab.quiver3d(ys[::stride], xs[::stride], t[::stride],
                            ones[::stride], ones[::stride], ones[::stride],
                            scalars=colors[::stride], mode=marker,
                            scale_factor=event_size, figure=fig)
        p3d.glyph.color_mode = "color_by_scalar"

    if elev or azim:
        mlab.view(azimuth=azim, elevation=elev)
    else:
        _apply_camera_preset(mlab)
    if save_path is not None:
        ensure_dir(os.path.dirname(save_path))
        mlab.savefig(save_path, figure=fig, magnification=8)
    if show_plot:
        mlab.show()
    return fig


def plot_events_sliding(xs, ys, ts, ps, args, dt=None, sdt=None, frames=None,
                        frame_ts=None, padding: bool = True):
    """Sliding-window mayavi video (reference
    draw_event_stream_mayavi.py:17-101): head-padded windows, per-window
    sphere render with in-volume frame planes, one saved frame per step."""
    mlab = _require_mlab()
    xs, ys, ts, ps = map(np.asarray, (xs, ys, ts, ps))
    if dt is None:
        dt = (ts[-1] - ts[0]) / 10
        sdt = dt / 10
    if sdt is None:  # window width given but stride not: advance one window
        sdt = dt
    num_show = getattr(args, "num_show", -1)
    skip = max(len(xs) // num_show, 1) if num_show and num_show > 0 else 1
    xs, ys, ts, ps = xs[::skip], ys[::skip], ts[::skip], ps[::skip]

    frame_ts = np.asarray([] if frame_ts is None else frame_ts, np.float64)
    if frame_ts.ndim == 2:
        frame_ts = frame_ts[:, 1]
    if padding:
        xs, ys, ts, ps, frame_ts = pad_sliding_head(xs, ys, ts, ps, frame_ts,
                                                    dt, sdt)
    frames = [] if frames is None else list(frames)
    sensor_size = (frames[0].shape if frames
                   else [int(max(ys)) + 1, int(max(xs)) + 1])

    for i, ((e0, e1), (f0, f1)) in enumerate(
            sliding_windows(ts, frame_ts, dt, sdt)):
        save_path = os.path.join(args.output_path,
                                 "frame_{:010d}.jpg".format(i))
        plot_events(xs[e0:e1], ys[e0:e1], ts[e0:e1], ps[e0:e1],
                    save_path=save_path, num_show=-1,
                    event_size=getattr(args, "event_size", 2),
                    imgs=frames[f0:f1], img_ts=frame_ts[f0:f1],
                    show_events=not getattr(args, "hide_events", False),
                    azim=getattr(args, "azim", 45),
                    elev=getattr(args, "elev", 0),
                    show_frames=not getattr(args, "hide_frames", False),
                    crop=getattr(args, "crop", None),
                    compress_front=getattr(args, "compress_front", False),
                    invert=getattr(args, "invert", False),
                    num_compress=getattr(args, "num_compress", 0),
                    show_plot=getattr(args, "show_plot", False),
                    img_size=sensor_size,
                    show_axes=getattr(args, "show_axes", False),
                    ts_scale=getattr(args, "ts_scale", 100000.0))
        mlab.clf()


def plot_voxel_grid(xs, ys, ts, ps, bins: int = 5, frames=(), frame_ts=(),
                    sensor_size=None, crop=None, elev=0, azim=45,
                    show_axes=False):
    """Voxel render — matplotlib, as in the reference's mayavi module
    (draw_event_stream_mayavi.py:103-158, whose own matplotlib import is
    commented out — a catalogued defect; the working twin is reused)."""
    from .draw_event_stream import plot_voxel_grid as mpl_voxels
    return mpl_voxels(xs, ys, ts, ps, bins=bins, frames=frames,
                      frame_ts=frame_ts, sensor_size=sensor_size, crop=crop,
                      elev=elev, azim=azim, show_axes=show_axes)


def plot_between_frames(xs, ys, ts, ps, frames, frame_event_idx, args,
                        plttype: str = "events"):
    """Frame-indexed mayavi video (reference
    draw_event_stream_mayavi.py:233-262)."""
    _require_mlab()
    crop = getattr(args, "crop", None)
    args.crop = None if crop is None else parse_crop(crop) \
        if isinstance(crop, str) else crop
    for i in range(0, len(frames), args.skip_frames):
        if getattr(args, "hide_skipped", False):
            frame = [frames[i]]
            frame_indices = np.asarray(frame_event_idx[i])[np.newaxis, ...]
        else:
            frame = frames[i:i + args.skip_frames]
            frame_indices = np.asarray(frame_event_idx[i:i + args.skip_frames])
        # canonical (start, end) rows: full span = first start..last end
        s, e = int(frame_indices[0, 0]), int(frame_indices[-1, 1])
        if e <= s:
            continue
        img_ts = [ts[min(max(int(f_idx[1]) - 1, 0), len(ts) - 1)]
                  for f_idx in frame_indices]
        fname = os.path.join(args.output_path, "events_{:09d}.png".format(i))
        if plttype == "voxel":
            plot_voxel_grid(xs[s:e], ys[s:e], ts[s:e], ps[s:e],
                            bins=args.num_bins, crop=args.crop, frames=frame,
                            frame_ts=img_ts, elev=args.elev, azim=args.azim)
        else:
            plot_events(xs[s:e], ys[s:e], ts[s:e], ps[s:e], save_path=fname,
                        num_show=args.num_show, event_size=args.event_size,
                        imgs=frame, img_ts=img_ts,
                        show_events=not args.hide_events, azim=args.azim,
                        elev=args.elev, show_frames=not args.hide_frames,
                        crop=args.crop, compress_front=args.compress_front,
                        invert=args.invert, num_compress=args.num_compress,
                        show_plot=args.show_plot,
                        stride=getattr(args, "stride", 1),
                        ts_scale=getattr(args, "ts_scale", 100000.0))
