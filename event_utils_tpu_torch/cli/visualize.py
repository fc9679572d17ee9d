"""Dataset-driven visualization CLI (port of
``event_utils_tpu.cli.visualize``; reference visualize.py).

Picks the dataset class from the path type (dir -> memmap, .npy -> npy,
else HDF5), builds a dataset returning raw events, and renders every item
with the selected visualizer: the images on the card unless ``--device
cpu`` is passed, the figures with matplotlib.
"""

from __future__ import annotations

import argparse
import os


def _num_compress(v):
    """--num_compress accepts "auto", "all", or an integer count (the
    str-typed flag previously made every numeric value a TypeError)."""
    return v if v in ("auto", "all") else int(v)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Render an event dataset to figures/video frames")
    parser.add_argument("path", help="HDF5 file / memmap dir / npy file")
    parser.add_argument("--output_path", type=str, default="visualization")
    parser.add_argument("--visualization", type=str, default="events",
                        choices=["events", "voxels", "voxel_image",
                                 "event_image", "ts_image"])
    parser.add_argument("--w_width", type=float, default=0.01,
                        help="t_seconds window width")
    parser.add_argument("--sw_width", type=float, default=None,
                        help="sliding-window OVERLAP in seconds (dataset "
                             "stride = w_width - sw_width). NB: "
                             "visualize_events/visualize_voxel use the same "
                             "flag name as a STRIDE — the split is "
                             "inherited from the reference CLIs")
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--show_plot", action="store_true")
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
    parser.add_argument("--crop", type=str, default=None,
                        help="Crop as WxH+X+Y")
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--start_frame", type=int, default=0)
    parser.add_argument("--end_frame", type=int, default=-1)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the images: 'cuda' (default; "
                             "raises without a card) or 'cpu'")
    return parser


def select_dataset(path):
    from ..data_loaders import DynamicH5Dataset, MemMapDataset, NpyDataset
    if os.path.isdir(path):
        return MemMapDataset
    if path.endswith(".npy"):
        return NpyDataset
    return DynamicH5Dataset


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..visualization import get_visualizer, parse_crop
    from ..utils.util import ensure_dir

    dataset_cls = select_dataset(args.path)
    voxel_method = {"method": "t_seconds", "t": args.w_width,
                    "sliding_window_t": args.sw_width or 0}
    dataset = dataset_cls(args.path, voxel_method=voxel_method,
                          return_events=True, return_voxelgrid=False,
                          return_format="numpy", device=args.device)
    visualizer = get_visualizer(args.visualization, dataset.sensor_resolution,
                                device=args.device)
    ensure_dir(args.output_path)

    crop = parse_crop(args.crop)
    end = len(dataset) if args.end_frame < 0 else min(args.end_frame,
                                                      len(dataset))
    kwargs = {}
    if args.visualization == "events":
        kwargs = dict(num_show=args.num_show, event_size=args.event_size,
                      elev=args.elev, azim=args.azim,
                      show_events=not args.hide_events,
                      show_frames=not args.hide_frames,
                      show_plot=args.show_plot, crop=crop,
                      compress_front=args.compress_front,
                      num_compress=args.num_compress, stride=args.stride,
                      invert=args.invert, show_axes=args.show_axes)
    elif args.visualization in ("voxels", "voxel_image"):
        kwargs = dict(bins=args.num_bins)

    try:
        for i in range(args.start_frame, end):
            data = dataset[i]
            out = os.path.join(args.output_path, f"frame_{i:010d}.png")
            visualizer.plot_events(data, out, **kwargs)
            print(f"[{i + 1}/{end}] -> {out}")
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
