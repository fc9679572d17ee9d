"""E2VID inference CLI: reconstruct an intensity video from a recording.

Port of ``event_utils_tpu.cli.reconstruct``, with the same arguments and
outputs: windows an H5/memmap recording, voxelizes, unrolls the recurrent
network with its state threaded across the whole recording (chunk by
chunk, so the output does not depend on ``--chunk``), and writes
``frame_NNNNN.png`` grayscale frames, ``timestamps.txt`` and, with
``--eval_gt``, ``metrics.json`` (PSNR/SSIM against the recording's frames).
It runs on the card unless ``--device cpu`` is passed.

The network is the one the ``--params`` file's ``__model_json__`` names
(``training.reconstruction.ReconstructionTrainer``): the JAX package's
``E2VID`` (ConvGRU state; the JAX package's own files), or, with
``"architecture": "UNetRecurrent"``, rpg_e2vid's network at its published
widths, whose state is one ``(h, c)`` ConvLSTM pair a level (files the
port writes with ``training.checkpointing.save_params_npz``; run it with
``--num_bins 5 --combined_channels``).

Differences from the JAX CLI:

- frames are written by ``utils.util.write_gray_png`` (standard library)
  instead of ``plt.imsave``: the same 8-bit levels within one, without
  matplotlib;
- weights come from ``--params`` (a ``params.npz`` of either package);
  ``--ckpt_dir`` (an orbax checkpoint) raises ``ConfigurationError``.

Example:
    python -m event_utils_tpu_torch.cli.reconstruct rec_dir \\
        --params runs/recon128v2/params.npz --output_dir out --eval_gt
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Reconstruct intensity frames from events with E2VID")
    parser.add_argument("path", help="H5 file or memmap dir")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--ckpt_dir", default=None,
                        help="orbax checkpoint of the JAX package: not "
                             "supported by the port (pass --params)")
    parser.add_argument("--ckpt_step", type=int, default=None,
                        help="with --ckpt_dir only")
    parser.add_argument("--params", default=None,
                        help="weights snapshot (.npz) written by either "
                             "package's train_reconstruction --params_out "
                             "(E2VID, ConvGRU state) or by the port's "
                             "save_params_npz (UNetRecurrent, (h, c) "
                             "ConvLSTM state); the architecture comes from "
                             "its embedded __model_json__ (omitted: the "
                             "port's E2VID with random init — pipeline "
                             "smoke only)")
    parser.add_argument("--method", default="between_frames",
                        choices=["between_frames", "k_events", "t_seconds"])
    parser.add_argument("--k", type=int, default=20000,
                        help="events per window (k_events)")
    parser.add_argument("--t", type=float, default=0.05,
                        help="window seconds (t_seconds)")
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--combined_channels", action="store_true")
    parser.add_argument("--chunk", type=int, default=8,
                        help="windows per device call (state threads across "
                             "chunks, so output is chunk-invariant)")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--npy", action="store_true",
                        help="also save the full stack as frames.npy")
    parser.add_argument("--eval_gt", action="store_true",
                        help="score reconstructions against the recording's "
                             "frames with PSNR/SSIM (between_frames only — "
                             "window i pairs with frame i)")
    parser.add_argument("--no_window_cache", action="store_true",
                        help="disable the sidecar .npz window cache "
                             "(default: voxelized windows are cached next "
                             "to an H5 recording, keyed on windowing params "
                             "and the file's mtime/size)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def _pad_to_multiple_hw(grids, multiple=8):
    """Zero-pad a tensor's trailing (H, W) dims to a multiple (UNet stride
    needs it), on its device: rows below, columns to the right."""
    import torch.nn.functional as F

    H, W = grids.shape[-2], grids.shape[-1]
    return F.pad(grids, (0, (-W) % multiple, 0, (-H) % multiple))


# Windows a batched build takes when the whole recording is gathered.
GATHER_CHUNK = 8


def _fetch_chunk(dataset, lo, hi, pad, gt_fn=None, device=None):
    """``(voxels (hi-lo, C, Hp, Wp) float32, gts | None)`` of windows
    ``lo .. hi-1``: each window's item from ``dataset[i]``, their voxel
    grids built in one batched call on the dataset's device (the scope
    ``deferred_grids``), stacked and padded there, and copied back in one
    copy. With ``device``, the stack is handed over as a float32 tensor
    on ``device`` instead, with no copy to the host (moved only where the
    dataset's device is another), and the windows count under
    ``reconstruct.card_windows`` too. Counts the windows under
    ``reconstruct.batched_windows``. ``gt_fn`` maps ``(dataset, i,
    item)`` to the ground-truth array for window i."""
    import numpy as np
    import torch

    from .._device import to_numpy
    from ..utils import profiling

    with dataset.deferred_grids():
        items = [dataset[i] for i in range(lo, hi)]
    voxels = pad(torch.stack([item["voxel"] for item in items]))
    profiling.count("reconstruct.batched_windows", hi - lo)
    if device is None:
        voxels = to_numpy(voxels)
    else:
        voxels = voxels.to(device=device, dtype=torch.float32)
        profiling.count("reconstruct.card_windows", hi - lo)
    gts = None if gt_fn is None else np.stack(
        [gt_fn(dataset, i, item) for i, item in zip(range(lo, hi), items)])
    return voxels, gts


def _gather_windows(dataset, n, pad, gt_fn=None):
    """(voxels (N, C, Hp, Wp), stamps (N,), gts (N, ...) | None) for the
    first ``n`` windows, built ``GATHER_CHUNK`` at a time by
    :func:`_fetch_chunk`."""
    import numpy as np

    chunks = [_fetch_chunk(dataset, lo, min(lo + GATHER_CHUNK, n), pad,
                           gt_fn) for lo in range(0, n, GATHER_CHUNK)]
    stamps = [float(dataset.ts(max(dataset.get_event_indices(i)[1] - 1, 0)))
              for i in range(n)]
    return (np.concatenate([v for v, _ in chunks]),
            np.asarray(stamps, np.float64),
            np.concatenate([g for _, g in chunks])
            if gt_fn is not None else None)


class ChunkFetch:
    """A recording's windows a chunk at a time, from
    :func:`_window_source`. ``fetch(lo, hi) -> (voxels (hi-lo, C, Hp, Wp)
    ndarray, gts | None)`` on the host; ``fetch.on(device, lo, hi)`` the
    same grids as a float32 tensor on ``device``, for a consumer that runs
    there. Streaming (``gathered`` None), both build the chunk in one
    batched call (:func:`_fetch_chunk`) and differ in their last step:
    ``on`` hands over the stack it built, with no copy to the host.
    Gathered (``(voxels, gts | None)`` of every window), both slice it and
    ``on`` uploads the slice. Each call is the span
    ``reconstruct.fetch``."""

    def __init__(self, dataset, pad, gt_fn=None, gathered=None):
        self.dataset, self.pad, self.gt_fn = dataset, pad, gt_fn
        self.gathered = gathered

    def __call__(self, lo, hi):
        from ..utils import profiling

        with profiling.span("reconstruct.fetch"):
            return self._take(lo, hi, None)

    def on(self, device, lo, hi):
        from ..utils import profiling

        with profiling.span("reconstruct.fetch"):
            return self._take(lo, hi, device)

    def _take(self, lo, hi, device):
        from .._device import as_f32

        if self.gathered is None:
            return _fetch_chunk(self.dataset, lo, hi, self.pad, self.gt_fn,
                                device)
        voxels, gts = self.gathered
        voxels = voxels[lo:hi]
        return (voxels if device is None else as_f32(voxels, device),
                None if gts is None else gts[lo:hi])


def _window_source(dataset, args, n, pad, gt_fn=None, gt_channels=1,
                   cache_suffix=".reconcache.npz"):
    """Chunkable window access: returns ``(fetch, stamps)``, ``fetch`` a
    :class:`ChunkFetch`.

    Small recordings are materialized once behind the sidecar cache
    (:func:`_window_arrays`); recordings whose padded windows would exceed
    ``EVENT_UTILS_TPU_WINCACHE_LIMIT_MB`` (default 2048, the JAX package's
    variable) stream O(chunk) windows per fetch instead. Both build the
    grids of a chunk of windows in one batched call
    (:func:`_fetch_chunk`). The sizing decision is metadata-only: a
    window's padded grid of the dataset's representation
    (``dataset.grid_shape()``: a voxel grid's channels at the sensor's
    size, or a stacked histogram's at its downsampled size), plus the
    ground truth at the sensor's size (``gt_channels`` = per-pixel gt
    channels: 1 frame / 2 flow)."""
    import os

    import numpy as np
    import torch

    H, W = int(dataset.sensor_resolution[0]), int(dataset.sensor_resolution[1])
    per_win = pad(torch.zeros(dataset.grid_shape())).numel() * 4
    if gt_fn is not None:
        per_win += gt_channels * H * W * 4
    limit = float(os.environ.get("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB",
                                 "2048")) * 2**20
    if n * per_win > limit:
        if not args.no_window_cache:
            print(f"window cache skipped: {n} windows x {per_win >> 10} KiB "
                  f"exceeds {int(limit) >> 20} MiB "
                  "(EVENT_UTILS_TPU_WINCACHE_LIMIT_MB); streaming")
        stamps = np.empty(n, np.float64)
        for i in range(n):
            _, idx1 = dataset.get_event_indices(i)
            stamps[i] = float(dataset.ts(max(idx1 - 1, 0)))
        return ChunkFetch(dataset, pad, gt_fn), stamps

    all_voxels, stamps, all_gts = _window_arrays(
        dataset, args, n, pad, gt_fn, cache_suffix)
    return ChunkFetch(dataset, pad, gt_fn, (all_voxels, all_gts)), stamps


def _window_arrays(dataset, args, n, pad, gt_fn=None,
                   cache_suffix=".reconcache.npz"):
    """:func:`_gather_windows` behind a sidecar .npz cache next to an H5
    recording (memmap directories are not cached).

    The cache file and its key are the JAX package's, so the two packages
    share it: keyed on windowing params + num_bins/channels + the source
    file's (mtime_ns, size); rebuilt when the key mismatches or the cache
    covers fewer than ``n`` windows. A corrupt or unwritable cache falls
    back to direct gathering."""
    import json
    import os
    import zipfile

    import numpy as np

    if args.no_window_cache or os.path.isdir(args.path):
        return _gather_windows(dataset, n, pad, gt_fn)
    st = os.stat(args.path)
    key = {"method": args.method, "k": args.k, "t": args.t,
           "num_bins": args.num_bins,
           "combined": bool(args.combined_channels),
           "src_mtime_ns": st.st_mtime_ns, "src_size": st.st_size}
    if dataset.representation != "voxel":
        # another representation's windows under a key of its own (a
        # voxel grid's key stays the JAX package's)
        key.update(representation=dataset.representation,
                   downsample=dataset.downsample)
    cache_path = args.path + cache_suffix
    need_gt = gt_fn is not None
    try:
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as z:
                if (json.loads(str(z["key"])) == key
                        and z["voxels"].shape[0] >= n
                        and (not need_gt or "gts" in z)):
                    gts = z["gts"][:n] if need_gt else None
                    return z["voxels"][:n], z["stamps"][:n], gts
    except (OSError, EOFError, KeyError, ValueError,
            zipfile.BadZipFile) as exc:
        print(f"window cache unreadable ({type(exc).__name__}); rebuilding")
    voxels, stamps, gts = _gather_windows(dataset, n, pad, gt_fn)
    try:
        payload = {"key": json.dumps(key), "voxels": voxels,
                   "stamps": stamps}
        if need_gt:
            payload["gts"] = gts
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, cache_path)
    except OSError as exc:
        print(f"window cache not written ({type(exc).__name__})")
    return voxels, stamps, gts


def _voxel_method(args):
    if args.method == "k_events":
        return {"method": "k_events", "k": args.k, "sliding_window_w": 0}
    if args.method == "t_seconds":
        return {"method": "t_seconds", "t": args.t, "sliding_window_t": 0}
    return {"method": "between_frames", "sliding_window_w": 0}


def _reject_ckpt_dir(args):
    from ..errors import ConfigurationError

    if args.ckpt_dir:
        raise ConfigurationError(
            "--ckpt_dir (an orbax checkpoint) is not supported by the port; "
            "pass --params with a .npz weights snapshot instead")


def main(argv=None):
    """Run the CLI; returns ``{"windows", "output_dir", "metrics"}``
    (``metrics`` is ``None`` without ``--eval_gt``)."""
    args = build_parser().parse_args(argv)
    _reject_ckpt_dir(args)

    import os

    import numpy as np

    from .._device import to_numpy
    from ..convert import read_model_json_npz
    from ..data_loaders import DynamicH5Dataset, MemMapDataset
    from ..training.reconstruction import ReconstructionTrainer
    from ..utils.util import write_gray_png

    if args.eval_gt and args.method != "between_frames":
        raise SystemExit("--eval_gt needs --method between_frames (window i "
                         "pairs with frame i)")

    cls = MemMapDataset if os.path.isdir(args.path) else DynamicH5Dataset
    dataset = cls(args.path, voxel_method=_voxel_method(args),
                  num_bins=args.num_bins,
                  combined_voxel_channels=args.combined_channels,
                  return_events=False, return_format="numpy",
                  device=args.device)

    H, W = dataset.sensor_resolution
    Hp, Wp = H + (-H) % 8, W + (-W) % 8
    model_kwargs = {}
    if args.params:
        model_kwargs = read_model_json_npz(args.params)
        if model_kwargs:
            print(f"model architecture from {args.params}: {model_kwargs}")
    trainer = ReconstructionTrainer(
        sensor_size=(Hp, Wp), num_bins=args.num_bins,
        combined_channels=args.combined_channels,
        model_kwargs=model_kwargs, device=dataset.device)
    if args.params:
        step = trainer.load_params(args.params)
        print(f"loaded weights snapshot {args.params} (step {step})")
    else:
        print("WARNING: no --params; reconstructing with random weights")

    os.makedirs(args.output_dir, exist_ok=True)
    n = len(dataset) if args.max_frames is None \
        else min(len(dataset), args.max_frames)
    # frames arrive /255-normalized from transform_frame
    frame_gt = (lambda ds, i, item:
                np.asarray(item["frame"], np.float32).squeeze()) \
        if args.eval_gt else None
    fetch_windows, stamps = _window_source(
        dataset, args, n, pad=_pad_to_multiple_hw, gt_fn=frame_gt)
    state = None
    frames_all = [] if args.npy else None
    psnrs, ssims = [], []
    written = 0
    for s0 in range(0, n, args.chunk):
        hi = min(s0 + args.chunk, n)
        idxs = range(s0, hi)
        voxels, gt_frames = fetch_windows(s0, hi)
        preds, state = trainer.reconstruct(voxels[:, None], state=state)
        imgs = to_numpy(preds)[:, 0, 0, :H, :W]  # (T, H, W) in [0, 1]
        for i, img in zip(idxs, imgs):
            write_gray_png(os.path.join(args.output_dir,
                                        f"frame_{written:05d}.png"), img)
            if frames_all is not None:
                frames_all.append(img)
            if args.eval_gt:
                from ..utils.metrics import psnr, ssim
                gt = gt_frames[i - s0]
                psnrs.append(float(psnr(img, gt)))
                ssims.append(float(ssim(img, gt)))
            written += 1
    np.savetxt(os.path.join(args.output_dir, "timestamps.txt"),
               np.asarray(stamps))
    if frames_all is not None:
        np.save(os.path.join(args.output_dir, "frames.npy"),
                np.stack(frames_all))
    print(f"wrote {written} frames to {args.output_dir}")
    dataset.close()
    metrics = None
    if psnrs:
        import json

        # steady state = back half of the recording, where the recurrent
        # state has history (the JAX package's split)
        t0 = len(psnrs) // 2
        metrics = {"psnr_db": round(float(np.mean(psnrs)), 3),
                   "ssim": round(float(np.mean(ssims)), 4),
                   "psnr_steady_db": round(float(np.mean(psnrs[t0:])), 3),
                   "ssim_steady": round(float(np.mean(ssims[t0:])), 4),
                   "psnr_per_frame": [round(p, 2) for p in psnrs],
                   "num_frames": len(psnrs),
                   # provenance: which weights and recording produced this
                   "params": args.params,
                   "recording": args.path}
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f)
        print(f"vs ground-truth frames: PSNR {metrics['psnr_db']} dB, "
              f"SSIM {metrics['ssim']} (steady-state "
              f"{metrics['psnr_steady_db']} dB / {metrics['ssim_steady']})")
    return {"windows": written, "output_dir": args.output_dir,
            "metrics": metrics}


if __name__ == "__main__":
    main()
