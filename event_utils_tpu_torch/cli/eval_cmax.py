"""Contrast-maximisation flow accuracy against ground truth (port of
``event_utils_tpu.cli.eval_cmax``).

Per window, solve ROI-tiled contrast maximisation (``grid_cmax_batched``,
on the card unless ``--device cpu``) and score the recovered per-ROI
velocities against the recording's ground-truth flow (e.g. a
``cli.simulate`` recording), reporting the median/mean AEE. Same flags
as the JAX CLI, plus ``--device``; ``main`` returns the metrics.

Example:
    python -m event_utils_tpu_torch.cli.simulate rec --velocity 30 -20
    python -m event_utils_tpu_torch.cli.eval_cmax rec --roi_size 16 16
"""

from __future__ import annotations

import argparse


def _pyramid_arg(v):
    """argparse type for --pyramid: an int level count or 'auto' — reject
    anything else at parse time, before any dataset work."""
    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--pyramid must be an integer or 'auto', got {v!r}")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Evaluate grid_cmax flow against ground-truth flow")
    parser.add_argument("path", help="H5 file or memmap dir WITH flow")
    parser.add_argument("--method", default="k_events",
                        choices=["k_events", "between_frames"],
                        help="k_events (default): longer windows with real "
                             "displacement; between_frames windows can be "
                             "too short for any contrast signal")
    parser.add_argument("--k", type=int, default=20000,
                        help="events per window (k_events)")
    parser.add_argument("--roi_size", type=int, nargs=2, default=(20, 20))
    parser.add_argument("--min_events", type=int, default=10)
    parser.add_argument("--maxiter", type=int, default=50)
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--max_windows", type=int, default=None)
    parser.add_argument("--warm_start", action="store_true",
                        help="Seed each window's solve from the previous "
                             "window's params")
    parser.add_argument("--smooth", default=None,
                        choices=["median"],
                        help="Neighbor-median flow smoothing (helps "
                             "textured scenes; see grid_cmax_batched)")
    parser.add_argument("--pyramid", default=1, type=_pyramid_arg,
                        help="Coarse-to-fine pyramid levels, or 'auto' "
                             "(see grid_cmax_batched)")
    parser.add_argument("--output", default=None,
                        help="Optional metrics.json path")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def main(argv=None):
    """Run the CLI; returns the metrics dict (``median_aee_px_s``,
    ``mean_aee_px_s``, ``num_rois``, ``roi_size``, ``windows``)."""
    args = build_parser().parse_args(argv)

    import os

    from ..data_loaders import DynamicH5Dataset, MemMapDataset

    vm = ({"method": "k_events", "k": args.k, "sliding_window_w": 0}
          if args.method == "k_events"
          else {"method": "between_frames", "sliding_window_w": 0})
    cls = MemMapDataset if os.path.isdir(args.path) else DynamicH5Dataset
    dataset = cls(args.path, voxel_method=vm,
                  return_events=True, return_voxelgrid=False,
                  return_format="numpy", device=args.device)
    try:
        return _eval(dataset, args)
    finally:
        dataset.close()


def _eval(dataset, args):
    import numpy as np

    from .._device import to_numpy
    from ..contrast_max.events_cmax import grid_cmax_batched

    if not dataset.has_flow:
        raise SystemExit(f"{args.path} carries no ground-truth flow")
    if len(np.asarray(dataset.frame_ts)) == 0:
        raise SystemExit(f"{args.path} has flow but no frame timestamps to "
                         "pair windows with")

    if args.pyramid != 1 and args.warm_start:
        print("note: --pyramid runs on the FIRST window only — a warm "
              "start (x0) suppresses the coarse-to-fine cascade on "
              "subsequent windows (see grid_cmax_batched)")

    H, W = dataset.sensor_resolution
    rh, rw = args.roi_size
    n = len(dataset) if args.max_windows is None \
        else min(len(dataset), args.max_windows)
    errs = []
    prev_params = None
    for i in range(n):
        item = dataset[i]
        ev = np.asarray(item["events"])
        if len(ev) < args.min_events:
            continue
        xs, ys, ts, ps = (ev[:, 0].astype(np.float32),
                          ev[:, 1].astype(np.float32),
                          ev[:, 2].astype(np.float32),
                          ev[:, 3].astype(np.float32))
        params, rois, f_evals, valid = grid_cmax_batched(
            xs, ys, ts, ps, roi_size=(rh, rw), img_size=(H, W),
            min_events=args.min_events, maxiter=args.maxiter,
            capacity=args.capacity, smooth=args.smooth,
            x0=prev_params if args.warm_start else None,
            pyramid=args.pyramid, device=dataset.device)
        params = to_numpy(params)
        rois = to_numpy(rois)
        valid = to_numpy(valid)
        if args.warm_start:
            # Invalid (empty/under-populated) ROIs carry garbage solver
            # output; zero velocity is the neutral seed for the next
            # window's warm refine.
            prev_params = np.where(valid[:, None], params, 0.0)
        # GT velocity field nearest the window's MID-time for both methods
        t_mid = 0.5 * (float(ts[0]) + float(ts[-1]))
        stamps = np.asarray(dataset.frame_ts)
        if len(stamps) == 1:
            gt_idx = 0
        else:
            hi = int(np.clip(np.searchsorted(stamps, t_mid), 1,
                             len(stamps) - 1))
            lo = hi - 1
            gt_idx = lo if (t_mid - stamps[lo]) <= (stamps[hi] - t_mid) \
                else hi
        gt = np.asarray(dataset.get_flow(gt_idx), np.float32)  # (2, H, W)
        for p, r, v in zip(params, rois, valid):
            if not v:
                continue
            yc = int(min(r[0] + rh // 2, H - 1))
            xc = int(min(r[1] + rw // 2, W - 1))
            errs.append(float(np.hypot(p[0] - gt[0, yc, xc],
                                       p[1] - gt[1, yc, xc])))
        running = (f"{np.median(errs):.2f}" if errs else "n/a")
        print(f"window {i + 1}/{n}: {int(valid.sum())} ROIs, "
              f"running median AEE {running} px/s", flush=True)

    if not errs:
        raise SystemExit("no window had enough events to evaluate")
    metrics = {"median_aee_px_s": round(float(np.median(errs)), 3),
               "mean_aee_px_s": round(float(np.mean(errs)), 3),
               "num_rois": len(errs), "roi_size": [rh, rw]}
    print(f"grid_cmax vs GT flow: median AEE {metrics['median_aee_px_s']} "
          f"px/s over {len(errs)} ROIs")
    if args.output:
        import json
        with open(args.output, "w") as f:
            json.dump(metrics, f)
    return dict(metrics, windows=n)


if __name__ == "__main__":
    main()
