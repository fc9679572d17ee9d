"""E2VID training CLI (port of
``event_utils_tpu.cli.train_reconstruction``).

Two routes, with the JAX CLI's flags:

- ``--simulate``: training in the loop on scenes simulated on the device,
  ``--carry_segments`` consecutive truncated-BPTT segments per scene with
  the ConvGRU state carried across them, held-out PSNR/SSIM at every eval
  (``--eval_scenes`` rebuilds a pinned eval batch from committed scene
  parameters: ``training/data/recon_eval_scenes.npz`` is stage 8's);
- a recording (H5 file, memmap directory, or a directory of ``.h5``
  recordings): ``between_frames`` windows through the port's datasets,
  grouped into ``(T, B, ...)`` sequences (``iter_sequences``), or with
  ``--cache_windows`` materialised once into the JAX package's
  ``.wincache_*`` sidecar (``materialize_windows``), optionally
  ``--shuffle``d (``iter_sequences_cached``).

It runs on the card unless ``--device cpu`` is passed. ``--ckpt_dir``
holds the port's own checkpoint format (``training.checkpointing``).
``--data_parallel`` shards the batch axis over the ranks of the process
group, as ``cli.train_flow``'s does (a world of one alone, N ranks under
``torchrun --nproc_per_node N``; only rank 0 writes and logs), on both
routes: JAX's shards only ``--simulate``.

Example (the stage-8 recipe of ``runs/recon128v2``):
    python -m event_utils_tpu_torch.cli.train_reconstruction --simulate \\
        --sensor 128 128 --seq_len 8 --batch_size 4 --capacity 294912 \\
        --window_t 0.05 --carry_segments 3 --burn_in 1 --lpips_weight 0.1 \\
        --mse_weight 4.0 --ema_decay 0.999 --recurrent_levels 3 \\
        --num_res_blocks 2 --lr 3e-5 --lr_end 3e-6 --eval_seed 0 \\
        --resume_params runs/recon128v2/params.npz --steps 3000 \\
        --params_out params.npz --metrics_out metrics.json
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train E2VID on simulated scenes or a recording with "
                    "frames")
    parser.add_argument("path", nargs="?", default=None,
                        help="H5 file, memmap dir or dir of .h5 recordings "
                             "(needs frames); omit with --simulate")
    parser.add_argument("--simulate", action="store_true",
                        help="training in the loop: simulate fresh scenes "
                             "on the device into truncated-BPTT sequences")
    parser.add_argument("--steps", type=int, default=1000,
                        help="steps for --simulate mode")
    parser.add_argument("--capacity", type=int, default=65536,
                        help="events per simulated scene (all its windows)")
    parser.add_argument("--v_max", type=float, default=40.0,
                        help="|velocity| bound (px/s) for --simulate scenes")
    parser.add_argument("--window_t", type=float, default=0.05,
                        help="seconds per voxel window (--simulate)")
    parser.add_argument("--sensor", nargs=2, type=int, default=(64, 64),
                        help="simulated sensor H W, multiples of 8")
    parser.add_argument("--metrics_out", default=None,
                        help="write {losses, psnr_curve, config} JSON here, "
                             "rewritten at every eval")
    parser.add_argument("--omega_max", type=float, default=0.0,
                        help="max |rotation rate| rad/s of --simulate scenes")
    parser.add_argument("--s_max", type=float, default=0.0,
                        help="max |divergence rate| 1/s of --simulate scenes")
    parser.add_argument("--eval_seed", type=int, default=None,
                        help="seed of the held-out batch (default --seed)")
    parser.add_argument("--eval_scenes", default=None,
                        help="rebuild the held-out batch from these scene "
                             "parameters (.npz of texture, v, ws)")
    parser.add_argument("--eval_every", type=int, default=100,
                        help="steps between held-out evals (0: none)")
    parser.add_argument("--carry_segments", type=int, default=1,
                        help="--simulate: consecutive seq_len segments per "
                             "scene, GRU state carried across them; "
                             "--capacity bounds the whole scene")
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--base_features", type=int, default=32,
                        help="E2VID encoder width at the first level")
    parser.add_argument("--recurrent_levels", type=int, default=1,
                        help="encoder levels carrying ConvGRU state, "
                             "deepest first")
    parser.add_argument("--num_res_blocks", type=int, default=0,
                        help="residual blocks at the bottleneck")
    parser.add_argument("--burn_in", type=int, default=0,
                        help="drop the loss of the first N windows of a "
                             "cold sequence")
    parser.add_argument("--seq_len", type=int, default=4,
                        help="truncated-BPTT unroll length (windows)")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="independent sequences per step")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr_end", type=float, default=None,
                        help="cosine-decay the learning rate from --lr to "
                             "this value over --steps (--simulate mode)")
    parser.add_argument("--params_out", default=None,
                        help="write the weights (the EMA when enabled) as a "
                             "flat .npz in the JAX package's layout")
    parser.add_argument("--lpips_weight", type=float, default=0.0,
                        help="random-feature perceptual loss weight")
    parser.add_argument("--mse_weight", type=float, default=0.0,
                        help="squared-error loss weight on top of L1")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="exponential moving average of the weights; "
                             "evals and --params_out then use it")
    parser.add_argument("--combined_channels", action="store_true",
                        help="single polarity-summed voxel (default: "
                             "pos/neg stacked, 2*num_bins channels)")
    parser.add_argument("--ckpt_dir", default=None,
                        help="resumable checkpoints (the port's format)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_params", default=None,
                        help="warm-start weights from a params .npz "
                             "(optimizer state re-initialized)")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the batch over the ranks of the "
                             "process group (torchrun; alone: one rank)")
    parser.add_argument("--cache_windows", action="store_true",
                        help="materialize every (voxel, frame) window once "
                             "per recording into a sidecar .npz")
    parser.add_argument("--shuffle", action="store_true",
                        help="random sequence start offsets each epoch "
                             "(needs --cache_windows)")
    parser.add_argument("--seed", type=int, default=0,
                        help="--shuffle sampling seed; also the scene seed "
                             "in --simulate mode")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def _model_kwargs(args):
    """Non-default E2VID architecture kwargs from the flags, reconciled with
    a resumed checkpoint's ``model.json`` or a ``--resume_params`` file's
    ``__model_json__``: the saved architecture wins where the flags are at
    their defaults, and an explicit flag that contradicts it is an error."""
    kwargs = {}
    if args.base_features != 32:
        kwargs["base_features"] = args.base_features
    if args.recurrent_levels != 1:
        kwargs["recurrent_levels"] = args.recurrent_levels
    if args.num_res_blocks:
        kwargs["num_res_blocks"] = args.num_res_blocks
    saved = source = None
    if args.resume and args.ckpt_dir:
        from ..training.checkpointing import read_model_config

        saved = read_model_config(args.ckpt_dir)
        source = "the checkpoint's model.json"
    elif args.resume_params:
        from ..training.checkpointing import read_model_json_npz

        saved = read_model_json_npz(args.resume_params)
        source = f"{args.resume_params}'s __model_json__"
    if saved:
        for k, v in kwargs.items():
            # a key missing from `saved` means the snapshot was built at
            # the default, which the explicit flag contradicts too
            if saved.get(k) != v:
                raise SystemExit(
                    f"--{k} {v} contradicts {source} "
                    f"({saved.get(k, 'default')}); "
                    "drop the flag to resume the saved architecture")
        merged = dict(saved)
        merged.update(kwargs)
        return merged
    return kwargs


def _window(item):
    """(voxel (C, Hp, Wp), frame (1, Hp, Wp)) float32 of a dataset item,
    padded as the serving CLIs pad their grids."""
    import numpy as np
    import torch

    from .reconstruct import _pad_to_multiple_hw

    vox = np.asarray(item["voxel"], np.float32)
    frame = np.asarray(item["frame"], np.float32)
    if frame.ndim == 2:
        frame = frame[None]
    return tuple(_pad_to_multiple_hw(torch.from_numpy(a)).numpy()
                 for a in (vox, frame))


def iter_sequences(dataset, seq_len, batch_size):
    """Group consecutive dataset windows into (T, B, C, H, W) voxel
    sequences + (T, B, 1, H, W) frame targets (frames arrive /255
    normalised from the dataset)."""
    import numpy as np

    n_seq = len(dataset) // seq_len
    per_batch = seq_len * batch_size
    for s0 in range(0, n_seq * seq_len - per_batch + 1, per_batch):
        voxels, frames = [], []
        for b in range(batch_size):
            vseq, fseq = zip(*(_window(dataset[s0 + b * seq_len + t])
                               for t in range(seq_len)))
            voxels.append(np.stack(vseq))
            frames.append(np.stack(fseq))
        yield np.stack(voxels, axis=1), np.stack(frames, axis=1)


def _source_stamp(src_path):
    """(mtime_ns, size) of a recording — for memmap dirs, of its t.npy."""
    import os

    p = src_path
    if os.path.isdir(p):
        t = os.path.join(p, "t.npy")
        p = t if os.path.exists(t) else p
    st = os.stat(p)
    return st.st_mtime_ns, st.st_size


def materialize_windows(dataset, cache_path=None, src_path=None,
                        save: bool = True):
    """Every between-frames window of ``dataset`` once: ``(N, C, H, W)``
    voxels + ``(N, 1, H, W)`` frames (HW padded to /8).

    With ``cache_path`` the stacks are saved to and loaded from a sidecar
    ``.npz``, keyed on the source recording's (mtime_ns, size) via
    ``src_path`` (the JAX package's file and key: the two packages share
    it); a regenerated recording at the same path rebuilds it. ``save=False``
    reads the sidecar but never writes it (the ranks but 0 of
    ``--data_parallel``)."""
    import os

    import numpy as np

    stamp = (np.asarray(_source_stamp(src_path), np.int64)
             if src_path else None)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            if stamp is None or ("src_stamp" in z
                                 and np.array_equal(z["src_stamp"], stamp)):
                return z["voxels"], z["frames"]
        if save:
            print(f"window cache stale ({cache_path}); rebuilding")
    voxels, frames = zip(*(_window(dataset[i]) for i in range(len(dataset))))
    voxels, frames = np.stack(voxels), np.stack(frames)
    if cache_path and save:
        payload = {"voxels": voxels, "frames": frames}
        if stamp is not None:
            payload["src_stamp"] = stamp
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, cache_path)
    return voxels, frames


def iter_sequences_cached(voxels, frames, seq_len, batch_size, rng=None):
    """Batch materialised window stacks into (T, B, C, H, W) sequences:
    ``iter_sequences``'s aligned batches with ``rng=None``; with an
    ``np.random.Generator``, as many batches per epoch, each sequence at a
    random start in ``[0, N - seq_len]``."""
    import numpy as np

    n = len(voxels)
    per_batch = seq_len * batch_size
    if n < per_batch:
        return
    t_idx = np.arange(seq_len)[None, :]
    if rng is None:
        n_seq = n // seq_len
        starts_list = [s0 + np.arange(batch_size) * seq_len
                       for s0 in range(0, n_seq * seq_len - per_batch + 1,
                                       per_batch)]
    else:
        starts_list = (rng.integers(0, n - seq_len + 1, size=batch_size)
                       for _ in range(n // per_batch))
    for starts in starts_list:
        idx = starts[:, None] + t_idx
        yield (voxels[idx].transpose(1, 0, 2, 3, 4),
               frames[idx].transpose(1, 0, 2, 3, 4))


def _trainer(args, sensor_size, learning_rate, model_kwargs, mesh):
    from ..training.reconstruction import ReconstructionTrainer

    return ReconstructionTrainer(
        sensor_size=sensor_size, num_bins=args.num_bins,
        combined_channels=args.combined_channels,
        learning_rate=learning_rate, lpips_weight=args.lpips_weight,
        model_kwargs=model_kwargs, burn_in=args.burn_in,
        mse_weight=args.mse_weight, ema_decay=args.ema_decay, mesh=mesh,
        device=args.device)


def _simulate(args):
    import numpy as np

    from ..training import train_reconstruction_in_the_loop
    from ..training.checkpointing import save_params_npz
    from .train_flow import (_say, learning_rate, make_data_parallel_mesh,
                             resume, write_json_atomic)

    mesh = make_data_parallel_mesh(args, simulate=True)
    say = _say(mesh)
    model_kwargs = _model_kwargs(args)
    trainer = _trainer(args, tuple(args.sensor), learning_rate(args),
                       model_kwargs, mesh)
    resume(trainer, args)
    config = {"sensor": list(args.sensor), "num_bins": args.num_bins,
              "seq_len": args.seq_len, "batch_size": args.batch_size,
              "steps": args.steps, "capacity": args.capacity,
              "v_max": args.v_max, "window_t": args.window_t,
              "lr": args.lr, "lr_end": args.lr_end,
              "lpips_weight": args.lpips_weight,
              "mse_weight": args.mse_weight, "ema_decay": args.ema_decay,
              "model_kwargs": model_kwargs,
              "carry_segments": args.carry_segments,
              "burn_in": args.burn_in, "seed": args.seed,
              "eval_seed": args.eval_seed, "eval_scenes": args.eval_scenes,
              "resume_params": args.resume_params, "device": args.device}

    def write_metrics(losses, curve):
        if not trainer.is_writer:
            return
        if args.metrics_out:
            write_json_atomic(args.metrics_out, {
                "losses": [round(float(x), 5) for x in losses],
                "psnr_curve": [[int(c[0])] + [round(float(x), 4)
                                              for x in c[1:]]
                               for c in curve],
                "config": config})
        if args.params_out:
            save_params_npz(trainer, args.params_out)

    stats = {}
    losses, curve = train_reconstruction_in_the_loop(
        trainer, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, capacity=args.capacity, v_max=args.v_max,
        window_t=args.window_t, seed=args.seed, omega_max=args.omega_max,
        s_max=args.s_max, carry_segments=args.carry_segments,
        eval_seed=args.eval_seed, eval_scenes=args.eval_scenes,
        eval_every=args.eval_every, ckpt_dir=args.ckpt_dir,
        on_eval=write_metrics if (args.metrics_out or args.params_out)
        else None, stats=stats)
    write_metrics(losses, curve)
    if args.params_out:
        say(f"final params saved to {args.params_out}")
    say(f"final loss: {np.mean(losses[-10:]):.5f} over {len(losses)} steps"
        + (f"; final PSNR {curve[-1][1]:.2f} dB / SSIM {curve[-1][2]:.3f}"
           if curve else ""))
    return {"losses": losses, "psnr_curve": curve,
            "params_out": args.params_out, "trainer": trainer, **stats}


def _datasets(args, say=print):
    import os

    from ..data_loaders import DynamicH5Dataset, MemMapDataset

    kwargs = dict(voxel_method={"method": "between_frames",
                                "sliding_window_w": 0},
                  num_bins=args.num_bins,
                  combined_voxel_channels=args.combined_channels,
                  return_events=False, return_frame=True,
                  return_format="numpy", device=args.device)
    # a directory of .h5 recordings trains over every file; sequences never
    # straddle recordings (the state must not carry across scenes)
    if os.path.isdir(args.path) and not os.path.exists(
            os.path.join(args.path, "t.npy")):
        h5s = sorted(os.path.join(args.path, f)
                     for f in os.listdir(args.path) if f.endswith(".h5"))
        if not h5s:
            raise SystemExit(f"{args.path} has neither t.npy (memmap) nor "
                             ".h5 recordings")
        say(f"training over {len(h5s)} recordings")
        return [(p, DynamicH5Dataset(p, **kwargs)) for p in h5s]
    if os.path.isdir(args.path):
        return [(args.path.rstrip("/"), MemMapDataset(args.path, **kwargs))]
    return [(args.path, DynamicH5Dataset(args.path, **kwargs))]


def _recordings(args):
    import itertools

    import numpy as np

    from ..training.checkpointing import save_params_npz
    from .train_flow import _say, make_data_parallel_mesh, resume

    mesh = make_data_parallel_mesh(args, simulate=False)
    say = _say(mesh)
    datasets = _datasets(args, say)
    try:
        usable = [(p, d) for p, d in datasets
                  if len(d) >= args.seq_len * args.batch_size]
        if not usable:
            raise SystemExit("no recording has enough between-frame "
                             "windows; reduce --seq_len/--batch_size")
        sizes = {tuple(d.sensor_resolution) for _, d in usable}
        if len(sizes) > 1:
            raise SystemExit(f"recordings disagree on sensor size: {sizes}")
        H, W = usable[0][1].sensor_resolution
        trainer = _trainer(args, (H + (-H) % 8, W + (-W) % 8), args.lr,
                           _model_kwargs(args), mesh)
        resume(trainer, args)
        if args.shuffle and not args.cache_windows:
            raise SystemExit("--shuffle needs --cache_windows")
        if args.cache_windows:
            tag = f"b{args.num_bins}" + ("c" if args.combined_channels
                                         else "")
            stacks = [materialize_windows(d, f"{p}.wincache_{tag}.npz",
                                          src_path=p,
                                          save=trainer.is_writer)
                      for p, d in usable]
        rng = np.random.default_rng(args.seed) if args.shuffle else None

        def batches():
            for epoch in range(args.epochs):
                for i, (_, dataset) in enumerate(usable):
                    seqs = (iter_sequences_cached(*stacks[i], args.seq_len,
                                                  args.batch_size, rng=rng)
                            if args.cache_windows else
                            iter_sequences(dataset, args.seq_len,
                                           args.batch_size))
                    for voxels, frames in seqs:
                        yield epoch, voxels, frames

        losses = []
        for epoch, voxels, frames in itertools.islice(
                batches(), args.max_steps or None):
            losses.append(trainer.train_sequence(voxels, frames))
            say(f"epoch {epoch} step {trainer.step} loss {losses[-1]:.4f}",
                flush=True)
    finally:
        for _, dataset in datasets:
            dataset.close()
    if args.ckpt_dir:
        trainer.save_checkpoint(args.ckpt_dir)
        say(f"checkpoint saved to {args.ckpt_dir} at step {trainer.step}")
    if args.params_out and trainer.is_writer:
        save_params_npz(trainer, args.params_out)
        say(f"final params saved to {args.params_out}")
    return {"losses": losses, "steps": len(losses),
            "params_out": args.params_out, "trainer": trainer}


def main(argv=None):
    """Run the CLI; returns ``{"losses", "steps", "params_out",
    "trainer"}`` (the trained ``ReconstructionTrainer``), with
    ``--simulate`` also ``psnr_curve`` and the loop's ``wall_s``, ``sim_s``
    and ``events``."""
    args = build_parser().parse_args(argv)
    if args.resume and args.resume_params:
        raise SystemExit("--resume (checkpoint) and --resume_params (npz "
                         "snapshot) are alternatives; pass one")
    if args.simulate:
        return _simulate(args)
    if args.path is None:
        raise SystemExit("path is required unless --simulate is given")
    return _recordings(args)


if __name__ == "__main__":
    main()
