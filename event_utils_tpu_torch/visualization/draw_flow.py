"""Dense-flow visualization: motion compensation and flow/event 3-D plots
(port of ``event_utils_tpu.visualization.draw_flow``, a rebuild of
reference ``lib/visualization/draw_flow.py``).

``motion_compensate`` computes on the device: the flow warp
(``warp_events_flow``) and the bilinear image of the warped events (the
bilinear kernel on the card). It writes its frame with
``utils.util.write_gray_png``, the standard-library PNG writer the serving
CLIs use, so it runs where matplotlib is not installed (the JAX package
calls ``plt.imsave``; the levels agree within one). The 3-D plots import
matplotlib when called.
"""

from __future__ import annotations

import os

import numpy as np

from .._device import as_f32, pick_device, to_numpy
from ..representations.image import events_to_image_torch
from ..transforms.optic_flow import warp_events_flow
from ..utils.event_util import clip_events_to_bounds
from ..utils.util import (ensure_dir, flow2bgr_np, normalize_image,
                          write_gray_png)
from .visualization_utils import (frame_stamps_to_start_end,
                                  get_frame_indices, parse_crop)


def motion_compensate(xs, ys, ts, ps, flow, fname=None, crop=None,
                      forward_flow: bool = True, device=None):
    """Warp events by a dense flow field and return (and, with ``fname``,
    save as a gray PNG) the normalised image of the warped events, flipped
    on both axes as the reference does (reference draw_flow.py:15-26).

    Divergence kept from the JAX package: the flows here are TRUE forward
    optic flow (simulator ground truth, EV-FlowNet's output), which the
    reference-faithful ``warp_events_flow`` compensates only when negated,
    so the default negates; ``forward_flow=False`` warps by ``flow`` as
    given. JAX's ``fname`` defaults to a file in the system's temporary
    directory; here nothing is written unless ``fname`` is given.

    @param flow ``(2, H, W)`` (leading singleton dims are squeezed)
    @param device Where numpy inputs go (default the card)
    @returns ``(H+1, W+1)`` float64 numpy image in [0, 1] (cropped by
        ``crop`` = ``[min_y, max_y, min_x, max_x]``)
    """
    dev = pick_device(flow, xs, ys, ts, ps, device=device)
    flow = as_f32(flow, dev)
    while flow.dim() > 3:   # batched model output
        flow = flow.squeeze(0)
    xw, yw = warp_events_flow(xs, ys, ts, ps,
                              -flow if forward_flow else flow, device=dev)
    img = events_to_image_torch(xw, yw, ps, device=dev,
                                sensor_size=tuple(flow.shape[-2:]),
                                interpolation="bilinear", impl="matmul")
    img = normalize_image(to_numpy(img.flip(0, 1)))
    if crop is not None:
        img = img[crop[0]:crop[1], crop[2]:crop[3]]
    if fname is not None:
        # scaled to its own range, as plt.imsave scales the cropped image
        ensure_dir(os.path.dirname(fname) or ".")
        write_gray_png(fname, normalize_image(img))
    return img


def plot_flow_and_events(xs, ys, ts, ps, flow, save_path=None,
                         num_show: int = 1000, event_size: float = 2,
                         elev: float = 0, azim: float = 45,
                         show_events: bool = True, show_plot: bool = False,
                         crop=None, marker: str = ".", stride: int = 20,
                         img_size=None, show_axes: bool = False,
                         invert: bool = False, quiver_stride: int = 20):
    """3-D plot of events over a color-coded flow ground plane with flow
    quivers (reference draw_flow.py:28-98). Imports matplotlib."""
    import matplotlib.pyplot as plt

    xs, ys, ts, ps = (to_numpy(a) for a in (xs, ys, ts, ps))
    flow = to_numpy(flow)
    while flow.ndim > 3:
        flow = flow[0]
    if img_size is None:
        img_size = flow.shape[1:3]
    crop = [0, img_size[0], 0, img_size[1]] if crop is None else crop
    xs, ys, ts, ps = clip_events_to_bounds(xs, ys, ts, ps, crop)
    xs, ys = xs - crop[2], ys - crop[0]
    flow = flow[:, crop[0]:crop[1], crop[2]:crop[3]]
    img_size = [crop[1] - crop[0], crop[3] - crop[2]]
    if len(xs) == 0:
        return None

    num_show = len(xs) if num_show == -1 else num_show
    skip = max(len(xs) // max(num_show, 1), 1)
    xs, ys, ts, ps = xs[::skip], ys[::skip], ts[::skip], ps[::skip]

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d", proj_type="ortho")
    colors = np.where(ps > 0, "r", "#00DAFF" if invert else "b")

    # flow color map as the ground plane at t0
    bgr = flow2bgr_np(flow[0], flow[1])
    rgb = bgr[..., ::-1].astype(float) / 255.0
    gy, gx = np.ogrid[0:img_size[0], 0:img_size[1]]
    ax.plot_surface(gx, np.full_like(gx, float(ts[0]), dtype=float), gy,
                    rstride=stride, cstride=stride, facecolors=rgb,
                    alpha=0.7)

    # sparse flow quivers
    qy, qx = np.mgrid[0:img_size[0]:quiver_stride, 0:img_size[1]:quiver_stride]
    u = flow[0][qy, qx]
    v = flow[1][qy, qx]
    ax.quiver(qx, np.full_like(qx, float(ts[0]), dtype=float), qy,
              u, np.zeros_like(u), v, length=0.05, normalize=True,
              color="k", alpha=0.5)

    if show_events:
        ax.scatter(xs, ts, ys, zdir="z", c=colors, s=event_size,
                   marker=marker, linewidths=0)

    ax.view_init(elev=elev, azim=azim)
    ax.grid(False)
    for pane in (ax.xaxis.pane, ax.yaxis.pane, ax.zaxis.pane):
        pane.fill = False
    if not show_axes:
        ax.set_axis_off()
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zticks([])

    if save_path is not None:
        ensure_dir(os.path.dirname(save_path) or ".")
        plt.savefig(save_path, transparent=True, dpi=300, bbox_inches="tight")
    if show_plot:
        plt.show()
    plt.close()
    return ax


def plot_between_frames(xs, ys, ts, ps, flows, flow_imgs, flow_ts, args,
                        plttype: str = "events", device=None):
    """Flow-synchronised sequence rendering (reference draw_flow.py:100-156):
    for each flow frame, the enclosed events' motion-compensated and
    uncompensated images (``flow_NNNNNNNNN_compensated.png`` / ``_raw.png``)
    and the 3-D plot over the flow plane (``_3d.png``).

    ``flow_imgs`` and ``plttype`` are accepted for the reference's
    signature and unused, as in JAX: the ground plane is coloured from
    ``flows`` and only the events rendering exists."""
    crop = None if args.crop is None else (
        args.crop if isinstance(args.crop, (list, tuple))
        else parse_crop(args.crop))
    xs, ys, ts, ps = (to_numpy(a) for a in (xs, ys, ts, ps))
    flow_ts = np.asarray(flow_ts)
    if flow_ts.ndim == 1:
        flow_ts = frame_stamps_to_start_end(flow_ts)
    flow_event_idx = get_frame_indices(ts, flow_ts)

    # n flow frames span n-1 intervals
    for i in range(0, min(len(flows), len(flow_event_idx)),
                   args.skip_frames):
        flow = np.asarray(flows[i])
        s, e = (int(flow_event_idx[i, 0]), int(flow_event_idx[i, 1]))
        if e <= s:
            continue
        base = os.path.join(args.output_path, f"flow_{i:09d}")
        motion_compensate(xs[s:e], ys[s:e], ts[s:e], ps[s:e], flow,
                          fname=base + "_compensated.png", crop=crop,
                          device=device)
        motion_compensate(xs[s:e], ys[s:e], ts[s:e], ps[s:e],
                          np.zeros_like(flow), fname=base + "_raw.png",
                          crop=crop, device=device)
        plot_flow_and_events(xs[s:e], ys[s:e], ts[s:e], ps[s:e], flow,
                             save_path=base + "_3d.png",
                             num_show=args.num_show,
                             event_size=args.event_size, elev=args.elev,
                             azim=args.azim,
                             show_events=not args.hide_events,
                             show_plot=args.show_plot, crop=crop,
                             stride=args.stride, show_axes=args.show_axes,
                             invert=args.invert)
