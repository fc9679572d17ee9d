"""EV-FlowNet inference CLI: dense flow fields from a recording.

Port of ``event_utils_tpu.cli.infer_flow``, with the same arguments and
outputs: windows a recording, voxelizes, runs EV-FlowNet per batch of
windows, and writes ``flow_NNNN.npy`` ``(2, H, W)`` fields (px/s) plus
``timestamps.txt``; ``--eval_gt`` adds ``metrics.json`` (AEE against the
recording's ground-truth flow, over the informative windows) and
``--render`` HSV renderings (needs matplotlib). It runs on the card unless
``--device cpu`` is passed. Weights come from ``--params`` (a JAX
``params.npz``); ``--ckpt_dir`` (an orbax checkpoint) raises
``ConfigurationError``.

Example:
    python -m event_utils_tpu_torch.cli.infer_flow rec_dir \\
        --params runs/flow128_similarity/params.npz \\
        --method between_frames --eval_gt --output_dir out
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Predict dense optical flow from events with EV-FlowNet")
    parser.add_argument("path", help="H5 file or memmap dir")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--ckpt_dir", default=None,
                        help="orbax checkpoint of the JAX package: not "
                             "supported by the port (pass --params)")
    parser.add_argument("--ckpt_step", type=int, default=None,
                        help="with --ckpt_dir only")
    parser.add_argument("--params", default=None,
                        help="weights snapshot (.npz) written by the JAX "
                             "package's train_flow --params_out (omitted: "
                             "random init — pipeline smoke only)")
    parser.add_argument("--method", default="k_events",
                        choices=["k_events", "t_seconds", "between_frames"])
    parser.add_argument("--k", type=int, default=20000)
    parser.add_argument("--t", type=float, default=0.05)
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--combined_channels", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="windows per device call")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--render", action="store_true",
                        help="also write flow_NNNN.png HSV renderings "
                             "(needs matplotlib)")
    parser.add_argument("--eval_gt", action="store_true",
                        help="score predictions against the recording's "
                             "ground-truth flow with AEE (between_frames "
                             "only)")
    parser.add_argument("--no_window_cache", action="store_true",
                        help="disable the sidecar .npz window cache")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def _save_rendering(path, flow):
    import matplotlib.pyplot as plt

    from ..utils.util import flow2bgr_np

    rgb = flow2bgr_np(flow[0], flow[1])[..., ::-1]  # BGR -> RGB
    plt.imsave(path, rgb)


def main(argv=None):
    """Run the CLI; returns ``{"windows", "output_dir", "metrics"}``
    (``metrics`` is ``None`` without ``--eval_gt``)."""
    args = build_parser().parse_args(argv)

    from .reconstruct import (_pad_to_multiple_hw, _reject_ckpt_dir,
                              _voxel_method, _window_source)

    _reject_ckpt_dir(args)

    import os

    import numpy as np

    from .._device import to_numpy
    from ..data_loaders import DynamicH5Dataset, MemMapDataset
    from ..training.loop import FlowTrainer

    if args.eval_gt and args.method != "between_frames":
        raise SystemExit("--eval_gt needs --method between_frames (window i "
                         "pairs with flow field i)")

    cls = MemMapDataset if os.path.isdir(args.path) else DynamicH5Dataset
    dataset = cls(args.path, voxel_method=_voxel_method(args),
                  num_bins=args.num_bins,
                  combined_voxel_channels=args.combined_channels,
                  return_events=False, return_format="numpy",
                  device=args.device)

    H, W = dataset.sensor_resolution
    if args.render:
        import matplotlib

        matplotlib.use("Agg")
    Hp, Wp = H + (-H) % 8, W + (-W) % 8
    trainer = FlowTrainer(sensor_size=(Hp, Wp), num_bins=args.num_bins,
                          combined_channels=args.combined_channels,
                          device=dataset.device)
    if args.params:
        step = trainer.load_params(args.params)
        print(f"loaded weights snapshot {args.params} (step {step})")
    else:
        print("WARNING: no --params; predicting with random weights")

    if args.eval_gt and not dataset.has_flow:
        raise SystemExit("--eval_gt: recording has no ground-truth flow")

    os.makedirs(args.output_dir, exist_ok=True)
    n = len(dataset) if args.max_frames is None \
        else min(len(dataset), args.max_frames)
    # get_flow(i) is the raw VELOCITY field (px/s) — the item dict's
    # 'flow' is already converted to displacement
    flow_gt = (lambda ds, i, item: np.asarray(ds.get_flow(i), np.float32)) \
        if args.eval_gt else None
    fetch_windows, all_stamps = _window_source(
        dataset, args, n, pad=_pad_to_multiple_hw, gt_fn=flow_gt,
        gt_channels=2, cache_suffix=".flowcache.npz")
    stamps = []
    aees = []
    base_aees = []
    vox_mass = []
    written = 0
    for s0 in range(0, n, args.batch_size):
        hi = min(s0 + args.batch_size, n)
        idxs = range(s0, hi)
        voxels, gt_flows = fetch_windows(s0, hi)
        flows = to_numpy(trainer.predict(voxels))[:, :, :H, :W]
        for i, flow in zip(idxs, flows):
            np.save(os.path.join(args.output_dir, f"flow_{written:04d}.npy"),
                    flow.astype(np.float32))
            stamps.append(float(all_stamps[i]))
            if args.render:
                _save_rendering(os.path.join(
                    args.output_dir, f"flow_{written:04d}.png"), flow)
            if args.eval_gt:
                from ..utils.metrics import average_endpoint_error

                # voxel mass ~ event count: flags (near-)empty windows —
                # e.g. the slice before the recording's first frame —
                # which carry no motion information to predict from
                vox_mass.append(float(np.abs(voxels[i - s0]).sum()))
                gt = gt_flows[i - s0]
                aees.append(float(average_endpoint_error(flow, gt)))
                base_aees.append(float(average_endpoint_error(
                    np.zeros_like(gt), gt)))
                if args.render:
                    _save_rendering(os.path.join(
                        args.output_dir, f"flow_gt_{written:04d}.png"), gt)
            written += 1
    dataset.close()
    np.savetxt(os.path.join(args.output_dir, "timestamps.txt"),
               np.asarray(stamps))
    print(f"wrote {written} flow fields to {args.output_dir}")
    metrics = None
    if aees:
        import json

        # Headline over INFORMATIVE windows only: a window holding <1% of
        # the median voxel mass (e.g. the empty slice before the first
        # frame of a between_frames recording) has nothing to predict
        # from. Per-window numbers (all windows) stay in metrics.json.
        mass = np.asarray(vox_mass)
        informative = mass >= 0.01 * max(float(np.median(mass)), 1e-9)
        aees_np = np.asarray(aees)
        base_np = np.asarray(base_aees)
        n_inf = int(informative.sum())
        metrics = {"aee_px_s": round(float(aees_np[informative].mean()), 3),
                   "zero_flow_aee_px_s":
                       round(float(base_np[informative].mean()), 3),
                   "num_fields": n_inf,
                   "num_fields_total": len(aees),
                   "aee_per_window": [round(float(a), 3) for a in aees],
                   "zero_flow_aee_per_window":
                       [round(float(a), 3) for a in base_np],
                   "voxel_mass_per_window":
                       [round(float(m), 1) for m in mass],
                   # provenance: which weights and recording produced this
                   "params": args.params,
                   "recording": args.path}
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f)
        skipped = len(aees) - n_inf
        print(f"vs ground-truth flow: AEE {metrics['aee_px_s']} px/s "
              f"over {n_inf} fields "
              f"(zero-flow baseline {metrics['zero_flow_aee_px_s']}"
              + (f"; {skipped} near-empty window(s) excluded" if skipped
                 else "") + ")")
    return {"windows": written, "output_dir": args.output_dir,
            "metrics": metrics}


if __name__ == "__main__":
    main()
