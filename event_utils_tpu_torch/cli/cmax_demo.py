"""Contrast-maximisation demo CLI (port of ``event_utils_tpu.cli.cmax_demo``):
optimise every objective of ``OBJECTIVE_REGISTRY`` on a slice of an HDF5
recording and print each one's argmax and its loss there and at the ground
truth (the reference's ``__main__`` demo, events_cmax.py:391-432).

``main`` parses the arguments, reads the slice (``read_slice``; ``h5py``
is imported there) and calls ``run``, which takes the event arrays and
does the work on the device: the port's scipy-BFGS ``optimize`` (the IWE
through the bilinear kernel on the card), or with ``--jit`` the whole
solve ``optimize_contrast_jit`` for objectives with a derivative. It runs
on the card unless ``--device cpu`` is passed. ``--draw_landscape`` plots
the variance landscape first (``draw_objective_function``; matplotlib).

    python -m event_utils_tpu_torch.cli.cmax_demo rec.h5 --gt 30 -20
"""

from __future__ import annotations

import argparse

import numpy as np

from ..errors import ConfigurationError, DataError


def build_parser():
    parser = argparse.ArgumentParser(
        description="Optimize all contrast objectives on an event slice")
    parser.add_argument("path", help="h5 events path")
    parser.add_argument("--gt", nargs="+", type=float, default=(0, 0))
    parser.add_argument("--img_size", nargs="+", type=int, default=(180, 240))
    parser.add_argument("--start_idx", type=int, default=20000)
    parser.add_argument("--num_events", type=int, default=15000)
    parser.add_argument("--draw_landscape", action="store_true")
    parser.add_argument("--jit", action="store_true",
                        help="Use the whole-solve device optimizer")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def read_slice(path, start_idx: int, num_events: int):
    """Events ``[start_idx, start_idx + num_events)`` of an HDF5 recording,
    stamps relative to its first event."""
    from ..data_formats import read_h5_event_components

    xs, ys, ts, ps = read_h5_event_components(path)
    if len(ts) == 0:
        raise DataError(f"{path} contains no events")
    total = len(ts)
    ts = ts - ts[0]
    s, e = start_idx, start_idx + num_events
    xs, ys, ts, ps = xs[s:e], ys[s:e], ts[s:e], ps[s:e]
    if len(ts) == 0:
        raise ConfigurationError(
            f"empty slice [{s}:{e}] of the file's {total} events — check "
            "--start_idx / --num_events")
    return xs, ys, ts, ps


def run(xs, ys, ts, ps, gt=(0, 0), img_size=(180, 240), jit: bool = False,
        device=None) -> dict:
    """Every objective of ``OBJECTIVE_REGISTRY`` optimised on the events:
    ``{name: {"argmax": (dims,) numpy, "loss": float, "gt_loss": float}}``
    in the registry's order (JAX ``cli/cmax_demo.py:51-65``)."""
    from .._device import pick_device, to_numpy
    from ..contrast_max import (OBJECTIVE_REGISTRY, linvel_warp, optimize,
                                optimize_contrast_jit)

    dev = pick_device(xs, ys, ts, ps, device=device)
    img_size = tuple(img_size)
    warp = linvel_warp()
    out = {}
    for name, obj_cls in OBJECTIVE_REGISTRY.items():
        obj = obj_cls()
        if jit and obj.has_derivative:
            argmax = optimize_contrast_jit(xs, ys, ts, ps, warp, obj,
                                           img_size=img_size,
                                           grid_search_init=True, device=dev)
        else:
            argmax = optimize(xs, ys, ts, ps, warp, obj, numeric_grads=True,
                              img_size=img_size, device=dev)
        argmax = np.asarray(to_numpy(argmax), np.float32)
        loss = obj.evaluate_function(argmax, xs, ys, ts, ps, warp,
                                     img_size=img_size, device=dev)
        gt_loss = obj.evaluate_function(np.asarray(gt, np.float32), xs, ys,
                                        ts, ps, warp, img_size=img_size,
                                        device=dev)
        out[name] = {"argmax": argmax, "loss": loss, "gt_loss": gt_loss}
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    xs, ys, ts, ps = read_slice(args.path, args.start_idx, args.num_events)
    img_size = tuple(args.img_size)
    gt = tuple(args.gt)
    if args.draw_landscape:
        from ..contrast_max import (draw_objective_function, linvel_warp,
                                    variance_objective)
        draw_objective_function(xs, ys, ts, ps, variance_objective(),
                                linvel_warp(), gt=gt, img_size=img_size,
                                show=True, device=args.device)
    results = run(xs, ys, ts, ps, gt=gt, img_size=img_size, jit=args.jit,
                  device=args.device)
    for name, r in results.items():
        print(f"{name}: argmax={np.round(r['argmax'], 2)} "
              f"loss={r['loss']:.4f} gt_loss={r['gt_loss']:.4f}")
    return results


if __name__ == "__main__":
    main()
