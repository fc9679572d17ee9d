"""Voxel-grid visualization CLI (port of
``event_utils_tpu.cli.visualize_voxel``; reference visualize_voxel.py):
``visualize_events``'s flags, voxel renders (the grids on the card unless
``--device cpu`` is passed)."""

from __future__ import annotations

import numpy as np

from .visualize_events import build_parser, load_any


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from ..visualization import draw_event_stream as renderer

    data, frame_data = load_any(
        args.path, need_frames=args.plot_method == "between_frames")
    xs, ys, ts, ps = data["xs"], data["ys"], data["ts"], data["ps"]
    frames = frame_data.get("frames", [])
    frame_idx = np.asarray(frame_data.get("frame_event_indices", []))

    if args.plot_method == "between_frames" and len(frames):
        fei = np.stack([np.concatenate([[0], frame_idx[:-1]]), frame_idx],
                       axis=1)
        renderer.plot_between_frames(xs, ys, ts, ps, frames, fei, args,
                                     plttype="voxel")
    else:
        import os
        from ..visualization import plot_voxel_grid, parse_crop
        from ..visualization.visualization_utils import k_event_windows
        if args.plot_method == "between_frames":
            print("NB: no frames in the recording — falling back to "
                  "sliding windows")
        crop = parse_crop(args.crop)
        os.makedirs(args.output_path, exist_ok=True)

        def windows():
            if args.plot_method == "k_events":  # real fixed-count windows
                yield from k_event_windows(len(xs), args.num_events)
            else:
                dt = args.w_width
                sdt = args.sw_width or dt
                for i, t0 in enumerate(np.arange(ts[0], ts[-1] - dt, sdt)):
                    e0, e1 = np.searchsorted(ts, (t0, t0 + dt))
                    yield i, e0, e1

        for i, e0, e1 in windows():
            if e1 <= e0:
                continue
            out = os.path.join(args.output_path, f"voxel_{i:09d}.png")
            plot_voxel_grid(xs[e0:e1], ys[e0:e1], ts[e0:e1], ps[e0:e1],
                            bins=args.num_bins, crop=crop,
                            elev=args.elev, azim=args.azim,
                            show_axes=args.show_axes, save_path=out,
                            show_plot=args.show_plot, device=args.device)


if __name__ == "__main__":
    main()
