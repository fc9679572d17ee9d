"""EV-FlowNet training CLI (port of ``event_utils_tpu.cli.train_flow``).

The file route trains on a recording (``FlowTrainer.fit``, ``--epochs``
passes of ``--k``-event windows): a memmap directory streams through a
shuffled ``NativeWindowedLoader``, an ``.h5`` file through an
``H5WindowedLoader`` (sequential slabs), and a directory of ``.h5`` files
through a ``ChainLoader`` of them that share one capacity.

The ``--simulate`` route trains in the loop on scenes simulated on the
device every step, with the JAX CLI's flags: the similarity family
(``--omega_max``, ``--s_max``), ``--burn_in``, ``--fresh_prob``,
``--age_max``, the supervised AEE term, ``--lr_end`` (cosine decay over
``--steps``, optax's formula), ``--metrics_out`` and ``--params_out``
rewritten atomically at every eval, ``--resume_params`` (a ``params.npz``
of either package) and ``--resume`` (the port's ``--ckpt_dir``). It runs
on the card unless ``--device cpu`` is passed.

Differences from the JAX CLI:

- training scenes come from ``torch.Generator`` draws
  (``training.in_the_loop``), so they agree with JAX's in distribution
  only; ``--eval_scenes`` rebuilds a pinned eval batch from committed scene
  parameters (``training/data/flow_eval_scenes.npz`` is stage 9's);
- ``--ckpt_dir`` holds the port's own checkpoint format
  (``training.checkpointing``), not orbax's;
- a memmap directory is shuffled with a generator seeded by ``--seed``
  (JAX's is unseeded), so every rank of ``--data_parallel`` reads the
  same order;
- ``--data_parallel`` runs one process per card (SPMD on
  ``torch.distributed``, ``parallel.make_mesh``) where JAX runs one
  controller over a device mesh: alone it is a world of one; under
  ``torchrun --nproc_per_node N`` it trains on N ranks, each on its slice
  of every batch (each simulating only its own scenes with ``--simulate``);
  only rank 0 writes checkpoints, ``--params_out``, ``--metrics_out`` and
  logs. Several ranks on one card pass ``--device cuda:0`` (gloo).

Data-parallel on two ranks (one card each, NCCL):
    torchrun --nproc_per_node 2 -m event_utils_tpu_torch.cli.train_flow \
        --simulate --data_parallel --sensor 128 128 --batch_size 8 --steps 3

Example (the stage-9 recipe of ``runs/flow128_similarity``):
    python -m event_utils_tpu_torch.cli.train_flow --simulate \\
        --sensor 128 128 --batch_size 8 --capacity 65536 --v_max 40 \\
        --omega_max 6 --s_max 0.6 --burn_in 1 --fresh_prob 0.25 \\
        --age_max 2.5 --supervised_weight 1.0 --lr 1e-4 --lr_end 5e-6 \\
        --eval_seed 0 --resume_params runs/flow128_similarity/params.npz \\
        --steps 6000 --params_out params.npz --metrics_out metrics.json
"""

from __future__ import annotations

import argparse
import time


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train EV-FlowNet self-supervised on an event file or "
                    "on simulated scenes")
    parser.add_argument("path", nargs="?", default=None,
                        help="memmap dir, H5 file or a directory of H5 "
                             "files; omit with --simulate")
    parser.add_argument("--simulate", action="store_true",
                        help="training in the loop: simulate fresh scenes "
                             "on the device every step (no files)")
    parser.add_argument("--steps", type=int, default=1000,
                        help="steps for --simulate mode")
    parser.add_argument("--capacity", type=int, default=16384,
                        help="per-scene event capacity for --simulate")
    parser.add_argument("--v_max", type=float, default=40.0,
                        help="|velocity| bound (px/s) for --simulate scenes")
    parser.add_argument("--window_t", type=float, default=0.1,
                        help="seconds of events per --simulate window")
    parser.add_argument("--num_frames", type=int, default=9,
                        help="rendered frames per --simulate window")
    parser.add_argument("--metrics_out", default=None,
                        help="write {losses, aee_curve, config} JSON here, "
                             "rewritten at every eval")
    parser.add_argument("--supervised_weight", type=float, default=0.0,
                        help="weight of the sim-supervised AEE term")
    parser.add_argument("--omega_max", type=float, default=0.0,
                        help="max |rotation rate| rad/s of --simulate scenes "
                             "(nonzero: dense similarity-field GT)")
    parser.add_argument("--s_max", type=float, default=0.0,
                        help="max |divergence rate| 1/s of --simulate scenes "
                             "(nonzero: dense similarity-field GT)")
    parser.add_argument("--burn_in", type=int, default=0,
                        help="extra simulated windows before the trained one "
                             "(steady-state sensor statistics); size "
                             "--capacity for burn_in+1 windows")
    parser.add_argument("--fresh_prob", type=float, default=0.0,
                        help="with --burn_in: probability that a scene "
                             "trains on its fresh first window instead of "
                             "the steady last one (eval stays steady)")
    parser.add_argument("--age_max", type=float, default=0.0,
                        help="per-scene age jitter in seconds: the rotation/"
                             "scale clock starts at U[0, age_max]")
    parser.add_argument("--seed", type=int, default=0,
                        help="scene seed (vary across resumed stages); the "
                             "window order of a memmap recording")
    parser.add_argument("--eval_seed", type=int, default=None,
                        help="seed of the held-out batch (default --seed)")
    parser.add_argument("--eval_scenes", default=None,
                        help="rebuild the held-out batch from these scene "
                             "parameters (.npz of texture, v, ws) instead of "
                             "drawing it")
    parser.add_argument("--eval_every", type=int, default=100,
                        help="steps between held-out evals (0: none)")
    parser.add_argument("--sensor", nargs=2, type=int, default=(64, 64),
                        help="sensor H W (multiples of 8)")
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--k", type=int, default=20000,
                        help="events per window (recordings)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=1,
                        help="passes over a recording")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr_end", type=float, default=None,
                        help="cosine-decay the learning rate from --lr to "
                             "this value over --steps")
    parser.add_argument("--params_out", default=None,
                        help="write the weights as a flat .npz (the JAX "
                             "package's layout), also at every eval")
    parser.add_argument("--ckpt_dir", default=None,
                        help="resumable checkpoints (the port's format)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest --ckpt_dir step")
    parser.add_argument("--resume_params", default=None,
                        help="warm-start weights from a params .npz "
                             "(optimizer state re-initialized)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the batch over the ranks of the "
                             "process group (torchrun; alone: one rank)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def _config(args) -> dict:
    return {"sensor": list(args.sensor), "num_bins": args.num_bins,
            "batch_size": args.batch_size, "steps": args.steps,
            "capacity": args.capacity, "v_max": args.v_max,
            "window_t": args.window_t, "num_frames": args.num_frames,
            "omega_max": args.omega_max, "s_max": args.s_max,
            "burn_in": args.burn_in, "fresh_prob": args.fresh_prob,
            "age_max": args.age_max, "lr": args.lr, "lr_end": args.lr_end,
            "supervised_weight": args.supervised_weight,
            # provenance: which scenes this stage saw, what it resumed from
            "seed": args.seed, "eval_seed": args.eval_seed,
            "eval_scenes": args.eval_scenes,
            "resume_params": args.resume_params, "device": args.device}


def learning_rate(args):
    """``--lr``, or its cosine decay to ``--lr_end`` over ``--steps``."""
    from ..training import cosine_decay_schedule

    if args.lr_end is None:
        return args.lr
    return cosine_decay_schedule(args.lr, decay_steps=args.steps,
                                 alpha=args.lr_end / args.lr)


def write_json_atomic(path: str, payload: dict) -> None:
    import json
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def resume(trainer, args) -> None:
    """``--resume`` from ``--ckpt_dir`` or ``--resume_params``."""
    say = _say(trainer.mesh)
    if args.resume and args.ckpt_dir:
        step = trainer.restore_checkpoint(args.ckpt_dir)
        say(f"resumed from step {step}")
    elif args.resume_params:
        step = trainer.load_params(args.resume_params)
        say(f"warm-started weights from {args.resume_params} "
            f"(step {step}; fresh optimizer state)")


def make_data_parallel_mesh(args, simulate: bool):
    """The ``--data_parallel`` mesh over the process group (a world of one
    without ``torchrun``), or ``None``; prints JAX's line."""
    if not args.data_parallel:
        return None
    from ..parallel import make_mesh

    mesh = make_mesh(axis_name="batch", device=args.device)
    _say(mesh)(f"data-parallel over {mesh.size()} devices"
               + (" (sharded in-the-loop simulation)" if simulate else ""))
    return mesh


def _say(mesh):
    """``print`` on the rank that logs (rank 0), a no-op on the others."""
    from ..parallel.sharding import is_writer

    return print if is_writer(mesh) else (lambda *a, **k: None)


def main(argv=None):
    """Run the CLI; returns ``{"losses", "aee_curve", "steps", "wall_s",
    "sim_s", "events", "params_out", "trainer"}`` (the loop's ``stats``
    and the trained ``FlowTrainer``; the file route has no ``aee_curve``
    or ``sim_s``, and its ``wall_s`` and ``events`` are those of the
    ``fit`` call)."""
    args = build_parser().parse_args(argv)
    if args.resume and args.resume_params:
        raise SystemExit("--resume (checkpoint) and --resume_params (npz "
                         "snapshot) are alternatives; pass one")

    import numpy as np

    from ..training import FlowTrainer, train_flow_in_the_loop
    from ..training.checkpointing import save_params_npz

    if not args.simulate:
        return train_on_recording(args)

    mesh = make_data_parallel_mesh(args, simulate=True)
    say = _say(mesh)
    trainer = FlowTrainer(sensor_size=tuple(args.sensor),
                          num_bins=args.num_bins,
                          learning_rate=learning_rate(args),
                          supervised_weight=args.supervised_weight,
                          mesh=mesh, device=args.device)
    resume(trainer, args)

    def write_metrics(losses, aee):
        # rewritten after every eval (atomic), so an interrupted run keeps
        # its curve and weights up to the last eval
        if not trainer.is_writer:
            return
        if args.metrics_out:
            write_json_atomic(args.metrics_out, {
                "losses": [round(float(x), 5) for x in losses],
                "aee_curve": [[int(s), round(float(a), 3)] for s, a in aee],
                "config": _config(args)})
        if args.params_out:
            save_params_npz(trainer, args.params_out)

    stats = {}
    losses, aee = train_flow_in_the_loop(
        trainer, steps=args.steps, batch_size=args.batch_size,
        capacity=args.capacity, v_max=args.v_max, seed=args.seed,
        window_t=args.window_t, num_frames=args.num_frames,
        omega_max=args.omega_max, s_max=args.s_max, burn_in=args.burn_in,
        fresh_prob=args.fresh_prob, age_max=args.age_max,
        eval_seed=args.eval_seed, eval_scenes=args.eval_scenes,
        eval_every=args.eval_every, ckpt_dir=args.ckpt_dir,
        on_eval=write_metrics if (args.metrics_out or args.params_out)
        else None, stats=stats)
    write_metrics(losses, aee)
    if args.params_out:
        say(f"final params saved to {args.params_out}")
    say(f"final loss: {np.mean(losses[-10:]):.5f} over {len(losses)} steps"
        + (f"; final AEE {aee[-1][1]:.2f} px/s" if aee else ""))
    return {"losses": losses, "aee_curve": aee,
            "params_out": args.params_out, "trainer": trainer, **stats}


def recording_loader(args, say=print):
    """The streaming loader of ``args.path`` (JAX ``cli/train_flow.py:
    207-240``); ``--data_parallel`` drops the last partial batch, as JAX
    does."""
    import os

    import numpy as np

    from ..data_loaders import (ChainLoader, H5WindowedLoader,
                                NativeWindowedLoader)

    if os.path.isdir(args.path) and not os.path.exists(
            os.path.join(args.path, "t.npy")):
        # a directory of .h5 recordings (simulate --num_sequences): one slab
        # loader per file, one shared capacity, so every batch has one shape
        h5s = sorted(os.path.join(args.path, f)
                     for f in os.listdir(args.path) if f.endswith(".h5"))
        if not h5s:
            raise SystemExit(f"{args.path} has neither t.npy (memmap) nor "
                             ".h5 recordings")
        cap = 1 << max(int(np.ceil(np.log2(max(args.k, 1)))), 0)
        loader = ChainLoader([
            H5WindowedLoader(p, method="k_events", k=args.k,
                             batch_size=args.batch_size, capacity=cap,
                             drop_last=args.data_parallel)
            for p in h5s])
        say(f"training over {len(h5s)} recordings "
            f"({len(loader)} batches/epoch)")
        return loader
    if os.path.isdir(args.path):
        return NativeWindowedLoader(args.path, method="k_events", k=args.k,
                                    batch_size=args.batch_size, shuffle=True,
                                    rng=np.random.default_rng(args.seed),
                                    drop_last=args.data_parallel)
    # HDF5: sequential slabs (shuffling would defeat the sequential chunk
    # reads; convert to memmap for shuffled epochs)
    return H5WindowedLoader(args.path, method="k_events", k=args.k,
                            batch_size=args.batch_size,
                            drop_last=args.data_parallel)


class _Counted:
    """``loader``, counting the real (unmasked) events of the batches it
    yields, for the route's Mev/s."""

    def __init__(self, loader):
        self.loader, self.events = loader, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import numpy as np
        for batch in self.loader:
            self.events += int(np.count_nonzero(batch["events_mask"]))
            yield batch


def train_on_recording(args):
    """The file route: ``FlowTrainer.fit`` over the recording's loader.
    Returns ``{"losses", "steps", "wall_s", "events", "params_out",
    "trainer"}``."""
    import numpy as np

    from ..training import FlowTrainer
    from ..training.checkpointing import save_params_npz

    if args.path is None:
        raise SystemExit("path is required unless --simulate is given")
    if args.supervised_weight:
        raise SystemExit("--supervised_weight needs --simulate (recordings "
                         "carry no per-window ground-truth flow here)")
    mesh = make_data_parallel_mesh(args, simulate=False)
    say = _say(mesh)
    loader = recording_loader(args, say)
    try:
        if len(loader) == 0:
            raise SystemExit(
                "No full batches: reduce --batch_size or --k "
                f"(windows of {args.k} events)")
        trainer = FlowTrainer(sensor_size=tuple(args.sensor),
                              num_bins=args.num_bins,
                              learning_rate=args.lr, mesh=mesh,
                              device=args.device)
        resume(trainer, args)
        counted = _Counted(loader)
        t0 = time.perf_counter()
        losses = trainer.fit(counted, epochs=args.epochs,
                             ckpt_dir=args.ckpt_dir)
        stats = {"wall_s": time.perf_counter() - t0,
                 "events": counted.events}
    finally:
        if hasattr(loader, "close"):
            loader.close()
    if args.params_out and trainer.is_writer:
        save_params_npz(trainer, args.params_out)
        say(f"final params saved to {args.params_out}")
    say(f"final loss: {np.mean(losses[-10:]):.5f} over {len(losses)} steps")
    return {"losses": losses, "steps": len(losses),
            "params_out": args.params_out, "trainer": trainer, **stats}


if __name__ == "__main__":
    main()
