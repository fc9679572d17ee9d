"""Optical-flow inference CLI: dense flow fields from a recording.

Port of ``event_utils_tpu.cli.infer_flow``, with the same arguments and
outputs: windows a recording, voxelizes, runs EV-FlowNet per batch of
windows, and writes ``flow_NNNN.npy`` ``(2, H, W)`` fields (px/s) plus
``timestamps.txt``; ``--eval_gt`` adds ``metrics.json`` (AEE against the
recording's ground-truth flow, over the informative windows) and
``--render`` HSV renderings (needs matplotlib). It runs on the card unless
``--device cpu`` is passed. Weights come from ``--params`` (a JAX
``params.npz``); ``--ckpt_dir`` (an orbax checkpoint) raises
``ConfigurationError``.

With ``--architecture ERAFT`` (or a ``--params`` file saved for it, whose
``__model_json__`` names it) the network is E-RAFT (``models.eraft``),
which predicts from pairs: field ``j`` is E-RAFT(window ``j``, window
``j + 1``) after ``--iters`` refinements, so ``n`` windows give ``n - 1``
fields, each stamped and scored (``--eval_gt``) as its later window. Its
displacement is written in px/s: over the time from the earlier window's
last event to the later window's last. A chunk of ``--batch_size`` pairs
fetches only its new windows and takes the previous chunk's last grid along
(``PairFetch``), so each grid is built once; a streaming fetch hands
the chunk it built over on the card, with no copy to the host. E-RAFT's
DSEC setting is ``--num_bins 15 --combined_channels``.

Example:
    python -m event_utils_tpu_torch.cli.infer_flow rec_dir \\
        --params runs/flow128_similarity/params.npz \\
        --method between_frames --eval_gt --output_dir out
    python -m event_utils_tpu_torch.cli.infer_flow dsec_rec --architecture \\
        ERAFT --iters 12 --num_bins 15 --combined_channels --method \\
        k_events --k 307200 --output_dir out
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Predict dense optical flow from events with EV-FlowNet "
                    "or E-RAFT")
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
                        help="windows (ERAFT: pairs) per device call")
    parser.add_argument("--architecture", default=None,
                        choices=["EVFlowNet", "ERAFT"],
                        help="the network (default: the --params file's, "
                             "else EVFlowNet)")
    parser.add_argument("--iters", type=int, default=None,
                        help="ERAFT's refinements (default: the --params "
                             "file's, else 12)")
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


def _model_kwargs(args) -> dict:
    """The network's ``model_kwargs``: a ``--params`` file's own
    (``__model_json__``), else what ``--architecture`` and ``--iters``
    name. Flags that name another network than the file raise
    ``SystemExit``."""
    if args.params:
        from ..convert import read_model_json_npz

        saved = read_model_json_npz(args.params)
        arch = saved.get("architecture", "EVFlowNet")
        if (args.architecture not in (None, arch) or args.iters
                not in (None, saved.get("iters"))):
            raise SystemExit(f"{args.params} holds {arch} {saved}: "
                             "--architecture / --iters name another network")
        return saved
    if args.architecture != "ERAFT":
        if args.iters is not None:
            raise SystemExit("--iters is ERAFT's (--architecture ERAFT)")
        return {}
    return {"architecture": "ERAFT",
            "iters": 12 if args.iters is None else args.iters}


class PairFetch:
    """The grids of windows ``lo .. hi`` on ``device``, for the pairs ``lo
    .. hi - 1``: ``pairs(lo, hi) -> (grids (hi - lo + 1, C, H, W), gts of
    windows lo + 1 .. hi | None)``, from ``fetch``
    (``cli.reconstruct._window_source``'s). A chunk that starts where the
    last one ended takes that chunk's last grid along and fetches only its
    new windows, so each grid is built once a pass; any other chunk
    fetches all of its windows. A ``fetch`` with an ``on(device, lo, hi)``
    method (``cli.reconstruct.ChunkFetch``) is asked for the grids on
    ``device``, where the streaming fetch keeps the chunk it built; a
    plain ``fetch(lo, hi)`` gives host arrays, uploaded here."""

    def __init__(self, fetch, device):
        self.fetch, self.device = fetch, device
        self.last = None        # (window index, its grid (1, C, H, W))

    def _take(self, lo, hi):
        on = getattr(self.fetch, "on", None)
        if on is not None:
            return on(self.device, lo, hi)

        from .._device import as_f32

        grids, gts = self.fetch(lo, hi)
        return as_f32(grids, self.device), gts

    def __call__(self, lo, hi):
        import torch

        if self.last is not None and self.last[0] == lo:
            new, gts = self._take(lo + 1, hi + 1)
            grids = torch.cat([self.last[1], new])
        else:
            grids, gts = self._take(lo, hi + 1)
            gts = None if gts is None else gts[1:]
        self.last = (hi, grids[-1:].clone())
        return grids, gts


def _window_fields(trainer, fetch, n, batch):
    """EV-FlowNet, field ``i`` from window ``i``: yields ``(windows, flows
    (B, 2, Hp, Wp) px/s on the host, gts, grids)`` a batch."""
    from .._device import to_numpy

    for s0 in range(0, n, batch):
        hi = min(s0 + batch, n)
        voxels, gts = fetch(s0, hi)
        yield range(s0, hi), to_numpy(trainer.predict(voxels)), gts, voxels


def _pair_fields(trainer, fetch, n, batch, stamps):
    """ERAFT, field ``j`` from windows ``j`` and ``j + 1``, as
    :func:`_window_fields` yields them for the later windows; the
    displacement over ``stamps[j + 1] - stamps[j]`` in px/s (zero where no
    time passed)."""
    import numpy as np

    from .._device import to_numpy

    pairs = PairFetch(fetch, trainer.device)
    for s0 in range(0, n - 1, batch):
        hi = min(s0 + batch, n - 1)
        grids, gts = pairs(s0, hi)
        flow, _ = trainer.predict_pairs(grids[:-1], grids[1:])
        dt = np.diff(np.asarray(stamps[s0:hi + 1], np.float64))
        per_s = np.where(dt > 0, 1.0 / np.where(dt > 0, dt, 1.0), 0.0)
        yield (range(s0 + 1, hi + 1), to_numpy(flow)
               * per_s.astype(np.float32)[:, None, None, None], gts,
               grids[1:])


def main(argv=None):
    """Run the CLI; returns ``{"windows", "output_dir", "metrics"}``
    (``metrics`` is ``None`` without ``--eval_gt``)."""
    args = build_parser().parse_args(argv)

    from .reconstruct import (_pad_to_multiple_hw, _reject_ckpt_dir,
                              _voxel_method, _window_source)

    _reject_ckpt_dir(args)

    import os

    import numpy as np

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
                          device=dataset.device,
                          model_kwargs=_model_kwargs(args))
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
    if trainer.takes_pairs:
        batches = _pair_fields(trainer, fetch_windows, n, args.batch_size,
                               all_stamps)
    else:
        batches = _window_fields(trainer, fetch_windows, n, args.batch_size)
    for idxs, flows, gt_flows, voxels in batches:
        for k, (i, flow) in enumerate(zip(idxs, flows[:, :, :H, :W])):
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
                vox_mass.append(float(abs(voxels[k]).sum()))
                gt = gt_flows[k]
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
