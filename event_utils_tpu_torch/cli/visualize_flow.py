"""Flow visualization CLI (port of ``event_utils_tpu.cli.visualize_flow``;
reference visualize_flow.py): loads dense flow frames (.npy files +
timestamps.txt, as ``stream_flow`` writes them) and renders the events
over them: motion-compensated and raw images on the card unless
``--device cpu`` is passed, and the 3-D plots with matplotlib."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(description="Flow + events renderer")
    parser.add_argument("path", help="HDF5 event file or memmap dir")
    parser.add_argument("--flow_path", required=True,
                        help="Directory of flow .npy frames + timestamps.txt")
    parser.add_argument("--output_path", type=str, default="visualization")
    parser.add_argument("--num_show", type=int, default=-1)
    parser.add_argument("--event_size", type=float, default=2)
    parser.add_argument("--elev", type=float, default=0)
    parser.add_argument("--azim", type=float, default=45)
    parser.add_argument("--hide_events", action="store_true")
    parser.add_argument("--hide_frames", action="store_true")
    parser.add_argument("--show_axes", action="store_true")
    parser.add_argument("--invert", action="store_true")
    parser.add_argument("--crop", type=str, default=None)
    parser.add_argument("--show_plot", action="store_true")
    parser.add_argument("--skip_frames", type=int, default=1)
    parser.add_argument("--stride", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the images: 'cuda' (default; "
                             "raises without a card) or 'cpu'")
    return parser


def load_flow_frames(flow_path):
    files = sorted(glob.glob(os.path.join(flow_path, "*.npy")))
    flows = [np.load(f) for f in files]
    ts_file = os.path.join(flow_path, "timestamps.txt")
    if os.path.exists(ts_file):
        stamps = np.loadtxt(ts_file)
        stamps = stamps[:, -1] if stamps.ndim == 2 else stamps
    else:
        stamps = np.arange(len(flows), dtype=float)
    return flows, np.asarray(stamps[:len(flows)])


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..visualization import draw_flow
    from .visualize_events import load_any

    data, _ = load_any(args.path)
    flows, flow_ts = load_flow_frames(args.flow_path)
    draw_flow.plot_between_frames(data["xs"], data["ys"], data["ts"],
                                  data["ps"], flows, flows, flow_ts, args,
                                  plttype="events", device=args.device)


if __name__ == "__main__":
    main()
