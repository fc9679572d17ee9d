"""Augmentation figure-sweep demo CLI (port of
``event_utils_tpu.cli.augment_demo``).

Counterpart of the reference's runnable ``__main__`` demo
(``lib/augmentation/event_augmentation.py:225-267``): load an event file,
render the raw window plus the add_correlated / add_random / remove /
rotate / flip augmentations as 3-D event-cloud figures, named after their
augmentation. The augmentations are the host (numpy) ops, seeded with
``np.random.default_rng(0)``, so the figures' inputs equal the JAX CLI's.

The figures need ``matplotlib``: without it ``main`` raises before any
work (the card's machine has none). ``augment_sweep`` is the sweep alone.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIGURES = ("raw", "add_correlated", "add_random", "remove", "rotate",
           "flip_x")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Render augmentation demo figures from an event file")
    parser.add_argument("path", help="HDF5 event file or memmap dir")
    parser.add_argument("--output_path", default="/tmp/extracted_data",
                        help="Folder for the rendered figures")
    parser.add_argument("--to_add", type=float, default=2.0,
                        help="Events to add, as a proportion of the window")
    parser.add_argument("--num", type=int, default=50000,
                        help="Events in the plotted window")
    parser.add_argument("--start", type=int, default=0,
                        help="First event of the window")
    parser.add_argument("--num_compress", type=int, default=5000)
    parser.add_argument("--elev", type=float, default=30)
    parser.add_argument("--show_plot", action="store_true")
    parser.add_argument("--sensor", type=int, nargs=2, default=(180, 240))
    return parser


def load_window(path, sensor, start: int, num: int):
    """Events ``[start, start + num)`` of an HDF5 file or memmap directory,
    y flipped as in the reference demo (event_augmentation.py:240)."""
    from ..data_formats.read_events import (read_h5_event_components,
                                            read_memmap_events)

    if os.path.isdir(path):
        data = read_memmap_events(path)
        xs = data["xy"][:, 0].astype(np.float64)
        ys = data["xy"][:, 1].astype(np.float64)
        ts = np.asarray(data["t"]).squeeze()
        ps = np.asarray(data["p"]).squeeze() * 2.0 - 1.0
    else:
        xs, ys, ts, ps = read_h5_event_components(path)
    ys = sensor[0] - ys
    s = start
    return (xs[s:s + num], ys[s:s + num], ts[s:s + num], ps[s:s + num])


def augment_sweep(xs, ys, ts, ps, sensor, to_add: float):
    """The demo's augmentations of one window, in figure order: ``{name:
    (xs, ys, ts, ps)}`` for the names of ``FIGURES``."""
    from ..augmentation.event_augmentation import (
        add_correlated_events, add_random_events, flip_events_x,
        remove_events, rotate_events)

    sensor = tuple(sensor)
    n_add = int(len(xs) * to_add)
    rng = np.random.default_rng(0)
    out = {"raw": (xs, ys, ts, ps)}
    out["add_correlated"] = add_correlated_events(xs, ys, ts, ps, n_add,
                                                  rng=rng)
    out["add_random"] = add_random_events(xs, ys, ts, ps, n_add,
                                          sensor_resolution=sensor, rng=rng)
    out["remove"] = remove_events(xs, ys, ts, ps, len(xs) // 2, rng=rng)
    # center_of_rotation is (cx, cy) = (x, y); clip_to_range=False keeps
    # the rotated coords index-aligned with their ts/ps
    rx, ry = rotate_events(xs, ys, sensor_resolution=sensor,
                           theta_radians=1.4,
                           center_of_rotation=(sensor[1] // 2,
                                               sensor[0] // 2),
                           clip_to_range=False)[:2]
    out["rotate"] = (rx, ry, ts, ps)
    out["flip_x"] = flip_events_x(xs, ys, ts, ps, sensor_resolution=sensor)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "augment_demo draws its figures with matplotlib, which is not "
            "installed here") from exc
    from ..visualization.draw_event_stream import plot_events

    xs, ys, ts, ps = load_window(args.path, args.sensor, args.start,
                                 args.num)
    os.makedirs(args.output_path, exist_ok=True)
    for name, (axs, ays, ats, aps) in augment_sweep(
            xs, ys, ts, ps, args.sensor, args.to_add).items():
        pth = os.path.join(args.output_path, name)
        plot_events(axs, ays, ats, aps, elev=args.elev,
                    num_compress=args.num_compress, num_show=-1,
                    save_path=pth, show_axes=True, compress_front=True,
                    show_plot=args.show_plot)
        print(f"wrote {pth}")


if __name__ == "__main__":
    main()
