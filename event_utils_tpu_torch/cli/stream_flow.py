"""Streaming video-flow pipeline (port of
``event_utils_tpu.cli.stream_flow``): the native streaming ingest
(``NativeWindowedLoader`` / ``H5WindowedLoader``) into the warm-started,
ROI-tiled contrast-maximisation solver (``grid_cmax_batched(x0=prev)``),
on the card unless ``--device cpu``.

Every k-event window yields a dense ``(2, H, W)`` flow field in px/s,
written as ``flow_NNNN.npy`` with the window's last stamp in
``timestamps.txt``, the layout the flow-visualization CLIs read; invalid
ROIs are zeroed before they seed the next window. ``metrics.json`` holds
the sustained throughput (Mev/s ingested and solved, windows/s) and, under
``"spans"``, where a window's host time went: the program's spans
(``utils.profiling``, on for the run) as mean ms a window by name
(``cmax.solve``, ``cmax.bucket``, ``cmax.descent``, ``cmax.grad``,
``loader.fill``, ...), ``h2d_mb_per_window``, the MB the solver copies
from the host to the device a window, and ``graph_captures`` and
``graph_replays``, the run's CUDA graphs of the ROI refine captured and
replayed. Spans time the host's issue of the work and never wait for the
card. ``patch_variance_vg_share`` is the share of the run's patch-loss
evaluations on the card that the fused kernel served (its launches over
those of every route a patch-loss evaluation launches,
``events_cmax.PATCH_LOSS_ROUTES``), null where none ran on the card.
``--render`` writes ``flow_NNNN.png`` HSV renderings with the standard
library (``utils.util.write_rgb_png``; JAX's CLI uses matplotlib, which
writes RGBA with the same levels).

Example:
    python -m event_utils_tpu_torch.cli.stream_flow scene.h5 \\
        --output_dir flow_stream --k 20000 --pyramid_first
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Stream a recording through warm-started grid_cmax "
                    "into dense flow fields")
    parser.add_argument("path", help="H5 file or memmap dir")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--k", type=int, default=20000,
                        help="events per window")
    parser.add_argument("--roi_size", type=int, nargs=2, default=(20, 20))
    parser.add_argument("--maxiter", type=int, default=30)
    parser.add_argument("--capacity", type=int, default=None,
                        help="per-ROI event capacity (grid_cmax)")
    parser.add_argument("--min_events", type=int, default=10)
    parser.add_argument("--smooth", default=None, choices=["median"])
    parser.add_argument("--denoise", type=float, default=0.0,
                        metavar="DELTA_T",
                        help="Drop background activity before solving: "
                             "keep only events with a neighbouring event "
                             "within DELTA_T seconds "
                             "(ops.denoise.background_activity_filter)")
    parser.add_argument("--pyramid_first", action="store_true",
                        help="solve the FIRST window with the coarse-to-"
                             "fine pyramid (global 4-DoF fit base); later "
                             "windows keep the temporal warm start")
    parser.add_argument("--sensor", type=int, nargs=2, default=None,
                        help="H W (default: metadata / max coordinate)")
    parser.add_argument("--max_windows", type=int, default=None)
    parser.add_argument("--render", action="store_true",
                        help="also write flow_NNNN.png HSV renderings")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def roi_params_to_dense_flow(params, valid, roi_size, img_size):
    """Piecewise-constant upsample of the (ny*nx, 2) ROI velocity grid to a
    dense ``(2, H, W)`` px/s field (invalid ROIs get the field median)."""
    import numpy as np

    H, W = img_size
    rh, rw = roi_size
    ny = (H + rh - 1) // rh
    nx = (W + rw - 1) // rw
    p = np.asarray(params, np.float32).reshape(ny, nx, 2).copy()
    v = np.asarray(valid).reshape(ny, nx)
    if v.any():
        fill = np.median(p[v], axis=0)
    else:
        fill = np.zeros(2, np.float32)
    p[~v] = fill
    dense = np.repeat(np.repeat(p, rh, axis=0), rw, axis=1)[:H, :W]
    return np.moveaxis(dense, -1, 0)


def open_stream(args):
    """``(loader, (H, W))`` of the recording: one k-event window a batch,
    absolute stamps."""
    import os

    import numpy as np

    if os.path.isdir(args.path):
        from ..data_loaders import NativeWindowedLoader, \
            memmap_sensor_resolution

        loader = NativeWindowedLoader(args.path, method="k_events",
                                      k=args.k, batch_size=1, shuffle=False,
                                      relative_time=False)
        if args.sensor is not None:
            return loader, tuple(args.sensor)
        sensor = memmap_sensor_resolution(args.path)
        if sensor is None:
            xy = np.asarray(loader.xy)
            sensor = (int(xy[:, 1].max()) + 1, int(xy[:, 0].max()) + 1)
        return loader, tuple(int(v) for v in sensor)

    import h5py

    from ..data_loaders import H5WindowedLoader

    loader = H5WindowedLoader(args.path, method="k_events", k=args.k,
                              batch_size=1, relative_time=False)
    if args.sensor is not None:
        return loader, tuple(args.sensor)
    with h5py.File(args.path, "r") as f:
        res = f.attrs.get("sensor_resolution")
    if res is None:
        loader.close()
        raise SystemExit("recording has no sensor_resolution attr; "
                         "pass --sensor H W")
    return loader, tuple(int(v) for v in res)


def main(argv=None):
    """Run the CLI; returns the metrics (also written to
    ``metrics.json``)."""
    args = build_parser().parse_args(argv)

    import json
    import os
    import time

    import numpy as np

    from .._device import resolve_device, to_numpy
    from ..contrast_max.events_cmax import (FUSED_PATCH_ROUTE,
                                            GRAPH_CAPTURES, GRAPH_REPLAYS,
                                            H2D_BYTES, PATCH_LOSS_ROUTES,
                                            grid_cmax_batched)
    from ..ops import cuda_scatter
    from ..ops.denoise import background_activity_filter
    from ..utils import profiling
    from ..utils.util import flow2bgr_np, write_rgb_png

    device = resolve_device(args.device)
    loader, (H, W) = open_stream(args)
    os.makedirs(args.output_dir, exist_ok=True)
    prev = None
    stamps = []
    n_events = 0
    n_windows = 0
    span_s, counts = {}, {}
    spans_were_on = profiling.enable_spans(True)
    launches_before = cuda_scatter.launch_counts()
    t_start = time.perf_counter()
    try:
        for batch in loader:
            if (args.max_windows is not None
                    and n_windows >= args.max_windows):
                break
            ev = batch["events"][0]
            ev = ev[batch["events_mask"][0] != 0]
            if args.denoise > 0 and len(ev):
                keep = to_numpy(background_activity_filter(
                    ev[:, 0], ev[:, 1], ev[:, 2], args.denoise,
                    sensor_size=(H, W), device=device))
                ev = ev[keep]
            if len(ev) < args.min_events:
                continue
            xs, ys, ts, ps = (np.ascontiguousarray(ev[:, i], np.float32)
                              for i in range(4))
            params, _rois, _f, valid = grid_cmax_batched(
                xs, ys, ts, ps, roi_size=tuple(args.roi_size),
                img_size=(H, W), min_events=args.min_events,
                maxiter=args.maxiter, capacity=args.capacity,
                smooth=args.smooth, x0=prev,
                pyramid=2 if (args.pyramid_first and prev is None) else 1,
                device=device)
            params, valid = to_numpy(params), to_numpy(valid)
            # zero invalid-ROI params before warm-starting the next window
            # (garbage seeds strand a solve that skips the grid search)
            prev = np.where(valid[:, None], params, 0.0).astype(np.float32)
            flow = roi_params_to_dense_flow(params, valid,
                                            tuple(args.roi_size), (H, W))
            np.save(os.path.join(args.output_dir,
                                 f"flow_{n_windows:04d}.npy"), flow)
            stamps.append(float(ts[-1]))
            if args.render:
                write_rgb_png(os.path.join(args.output_dir,
                                           f"flow_{n_windows:04d}.png"),
                              flow2bgr_np(flow[0], flow[1])[..., ::-1])
            taken = profiling.take(request=n_windows)
            for name, sec in profiling.totals(taken.spans).items():
                span_s[name] = span_s.get(name, 0.0) + sec
            for name, n in taken.counts.items():
                counts[name] = counts.get(name, 0) + n
            n_events += len(ev)
            n_windows += 1
            elapsed = time.perf_counter() - t_start
            print(f"window {n_windows}: {len(ev)} events, sustained "
                  f"{n_events / elapsed / 1e6:.2f} Mev/s, "
                  f"{n_windows / elapsed:.2f} windows/s", flush=True)
    finally:
        profiling.enable_spans(spans_were_on)
        loader.close()

    if n_windows == 0:
        raise SystemExit("no window had enough events")
    elapsed = time.perf_counter() - t_start
    np.savetxt(os.path.join(args.output_dir, "timestamps.txt"),
               np.asarray(stamps))
    spans = {"ms_per_window": {k: round(v / n_windows * 1e3, 3)
                               for k, v in sorted(span_s.items())},
             "h2d_mb_per_window": round(
                 counts.get(H2D_BYTES, 0) / n_windows / 1e6, 4),
             "graph_captures": counts.get(GRAPH_CAPTURES, 0),
             "graph_replays": counts.get(GRAPH_REPLAYS, 0)}
    launched = {k: v - launches_before[k]
                for k, v in cuda_scatter.launch_counts().items()}
    evaluations = sum(launched[k] for k in PATCH_LOSS_ROUTES)
    metrics = {"mevs_sustained": round(n_events / elapsed / 1e6, 3),
               "windows_per_s": round(n_windows / elapsed, 3),
               "num_windows": n_windows, "num_events": int(n_events),
               "wallclock_s": round(elapsed, 2), "spans": spans,
               "patch_variance_vg_share": (
                   round(launched[FUSED_PATCH_ROUTE] / evaluations, 6)
                   if evaluations else None)}
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    print(f"wrote {n_windows} flow fields to {args.output_dir}: "
          f"{metrics['mevs_sustained']} Mev/s sustained, "
          f"{metrics['windows_per_s']} windows/s")
    return metrics


if __name__ == "__main__":
    main()
