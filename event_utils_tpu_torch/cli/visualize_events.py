"""Raw-reader 3-D event visualization CLI (port of
``event_utils_tpu.cli.visualize_events``; reference visualize_events.py):
sliding-window, fixed-count or between-frames rendering straight from an
event file, with matplotlib or mayavi. The structure layer and voxel
renders are computed on the card unless ``--device cpu`` is passed."""

from __future__ import annotations

import argparse
import numpy as np


def _num_compress(v):
    """--num_compress accepts "auto", "all", or an integer count (the
    str-typed flag previously made every numeric value a TypeError)."""
    return v if v in ("auto", "all") else int(v)


def build_parser():
    parser = argparse.ArgumentParser(description="3-D event stream renderer")
    parser.add_argument("path", help="HDF5 file or memmap dir")
    parser.add_argument("--output_path", type=str, default="visualization")
    parser.add_argument("--plot_method", default="between_frames",
                        choices=["between_frames", "k_events", "t_seconds"])
    parser.add_argument("--renderer", default="matplotlib",
                        choices=["matplotlib", "mayavi"])
    parser.add_argument("--w_width", type=float, default=0.01)
    parser.add_argument("--sw_width", type=float, default=None,
                        help="sliding-window STRIDE in seconds (default:\n                        advance one full window). NB: visualize.py's\n                        flag of the same name is an OVERLAP — that\n                        semantic split is inherited from the\n                        reference CLIs")
    parser.add_argument("--num_show", type=int, default=-1)
    parser.add_argument("--event_size", type=float, default=2)
    parser.add_argument("--elev", type=float, default=0)
    parser.add_argument("--azim", type=float, default=45)
    parser.add_argument("--hide_events", action="store_true")
    parser.add_argument("--hide_frames", action="store_true")
    parser.add_argument("--show_axes", action="store_true")
    parser.add_argument("--num_compress", type=_num_compress,
                        default="auto")
    parser.add_argument("--compress_front", action="store_true")
    parser.add_argument("--invert", action="store_true")
    parser.add_argument("--crop", type=str, default=None)
    parser.add_argument("--show_plot", action="store_true")
    parser.add_argument("--skip_frames", type=int, default=1)
    parser.add_argument("--hide_skipped", action="store_true")
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--num_events", type=int, default=20000,
                        help="events per window (k_events plot method)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the images: 'cuda' (default; "
                             "raises without a card) or 'cpu'")
    return parser


def load_any(path, need_frames: bool = True):
    import os
    from ..data_formats import read_h5_events_dict, read_memmap_events
    if os.path.isdir(path):
        raw = read_memmap_events(path, return_events=True)
        xy = np.asarray(raw["xy"])
        events = {"xs": xy[:, 0].squeeze(), "ys": xy[:, 1].squeeze(),
                  "ts": np.asarray(raw["t"]).squeeze(),
                  "ps": np.asarray(raw["p"]).squeeze()}
        frame_data = {}
        if (need_frames and "images" in raw and "index" in raw
                and "frame_stamps" in raw):
            frame_data = {"frames": list(np.asarray(raw["images"])),
                          "frame_timestamps": np.asarray(raw["frame_stamps"]),
                          "frame_event_indices": np.asarray(raw["index"])[:, 1]}
        return events, frame_data
    data = read_h5_events_dict(path)
    return data, data


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.renderer == "mayavi":
        from ..visualization import draw_event_stream_mayavi as renderer
    else:
        from ..visualization import draw_event_stream as renderer

    data, frame_data = load_any(
        args.path, need_frames=args.plot_method == "between_frames")
    xs, ys, ts, ps = data["xs"], data["ys"], data["ts"], data["ps"]
    frames = frame_data.get("frames", [])
    frame_ts = np.asarray(frame_data.get("frame_timestamps", []))
    frame_idx = np.asarray(frame_data.get("frame_event_indices", []))

    if args.plot_method == "between_frames" and len(frames):
        fei = np.stack([np.concatenate([[0], frame_idx[:-1]]), frame_idx],
                       axis=1)
        renderer.plot_between_frames(xs, ys, ts, ps, frames, fei, args,
                                     plttype="events")
    elif args.plot_method == "k_events":
        # Fixed-count windows (the reference's branch is a bare `pass`,
        # visualize_events.py:92-94 — implemented here for real).
        import os

        from ..visualization.visualization_utils import k_event_windows

        os.makedirs(args.output_path, exist_ok=True)
        wins = list(k_event_windows(len(xs), args.num_events))
        n_win = len(wins)
        for i, s, e in wins:
            fname = os.path.join(args.output_path, f"events_{i:09d}.png")
            from ..visualization.visualization_utils import parse_crop
            crop = None if args.crop is None else parse_crop(args.crop)
            kw = ({"device": args.device} if args.renderer == "matplotlib"
                  else {})
            renderer.plot_events(
                xs[s:e], ys[s:e], ts[s:e], ps[s:e], save_path=fname,
                num_show=args.num_show, event_size=args.event_size,
                elev=args.elev, azim=args.azim, crop=crop,
                compress_front=args.compress_front, invert=args.invert,
                num_compress=args.num_compress, show_plot=args.show_plot,
                stride=args.stride, show_axes=args.show_axes, **kw)
            print(f"[{i + 1}/{n_win}] -> {fname}")
    else:
        if args.plot_method == "between_frames" and not len(frames):
            print("NB: no frames in the recording — falling back to "
                  "t_seconds sliding windows")
        renderer.plot_events_sliding(xs, ys, ts, ps, args,
                                     dt=args.w_width, sdt=args.sw_width,
                                     frames=frames,
                                     frame_ts=frame_ts)


if __name__ == "__main__":
    main()
