"""Simulated-sequence generator CLI (port of
``event_utils_tpu.cli.simulate``).

Renders a parametric moving scene through the port's ESIM-style sensor
model (``simulation/esim.py``) on the card (``--device cpu`` for the host)
and writes a ground-truth recording (events, 8-bit frames, dense flow,
metadata, and ``gt.json``) through the port's packagers: memmap by
default, ``.h5`` for an ``.h5`` path (needs h5py). Same flags as the JAX
CLI, plus ``--device`` and ``--texture``: a float32 ``.npy`` texture (as
``--params`` carries weights) in place of the seed's own, which the port
draws from ``torch.Generator`` and so differs from JAX's threefry draw.
The textures of the published recordings are committed
(``simulation.texture_path``).

Example (the seed-91 flow recording of ``runs/flow128_similarity``, with
``T=event_utils_tpu_torch/simulation/textures``):
    python -m event_utils_tpu_torch.cli.simulate rec --scene similarity \\
        --sensor 128 128 --velocity 24 -15 --omega 4.0 --divergence 0.35 \\
        --duration 2.0 --fps 100 --frame_fps 10 --c_pos 0.15 --c_neg 0.15 \\
        --octaves 3 --seed 91 --texture $T/seed91_128x128_o3.npy
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..errors import ConfigurationError


def build_parser():
    parser = argparse.ArgumentParser(
        description="Simulate an event-camera sequence with ground truth")
    parser.add_argument("output_path",
                        help="Output .h5 file or memmap directory")
    parser.add_argument("--scene",
                        choices=("translate", "rotate", "similarity"),
                        default="translate",
                        help="similarity = rotation + divergence about the "
                             "sensor center (spatially-varying dense GT "
                             "flow)")
    parser.add_argument("--sensor", type=int, nargs=2, default=(180, 240),
                        metavar=("H", "W"))
    parser.add_argument("--velocity", type=float, nargs=2,
                        default=(30.0, -20.0), metavar=("VX", "VY"),
                        help="Texture velocity in px/s (translate scene)")
    parser.add_argument("--omega", type=float, default=1.5,
                        help="Angular velocity in rad/s (rotate/similarity "
                             "scenes)")
    parser.add_argument("--divergence", type=float, default=0.0,
                        help="Expansion rate in 1/s (similarity scene)")
    parser.add_argument("--duration", type=float, default=0.5,
                        help="Sequence length in seconds")
    parser.add_argument("--fps", type=float, default=200.0,
                        help="Internal render rate (timestamp resolution)")
    parser.add_argument("--frame_fps", type=float, default=25.0,
                        help="Rate at which frames/flow are written out")
    parser.add_argument("--c_pos", type=float, default=0.2)
    parser.add_argument("--c_neg", type=float, default=0.2)
    parser.add_argument("--sigma_c", type=float, default=0.0,
                        help="Per-pixel threshold-mismatch sigma")
    parser.add_argument("--refractory", type=float, default=0.0,
                        help="Refractory period in seconds")
    parser.add_argument("--leak_rate", type=float, default=0.0,
                        help="Per-pixel background-activity rate in Hz "
                             "(spurious ON 'leak' events)")
    parser.add_argument("--shot_rate", type=float, default=0.0,
                        help="Per-pixel random-polarity shot-noise rate, Hz")
    parser.add_argument("--hot_pixels", type=float, default=0.0,
                        help="Fraction of pixels that are hot (stuck-ON "
                             "at --hot_pixel_rate Hz)")
    parser.add_argument("--hot_pixel_rate", type=float, default=100.0,
                        help="Extra ON-leak rate of each hot pixel in Hz")
    parser.add_argument("--noise_slots", type=int, default=4,
                        help="Static noise-event slots per pixel per frame "
                             "interval; must hold the configured rates "
                             "(the simulator errors with the needed value)")
    parser.add_argument("--octaves", type=int, default=4,
                        help="Texture octaves (higher = finer structure)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--format", choices=("h5", "memmap"), default=None,
                        help="Default: memmap if output_path is a directory-"
                             "style path (no .h5 suffix), else h5")
    parser.add_argument("--num_sequences", type=int, default=1,
                        help="Write N recordings seq_000.h5.. into "
                             "output_path (a directory): per-sequence "
                             "random texture and motion magnitude/direction "
                             "drawn from the given parameters")
    parser.add_argument("--texture", default=None,
                        help="float32 .npy texture of the sensor's shape "
                             "(e.g. a committed JAX texture) in place of "
                             "the one drawn from --seed")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    return parser


def main(argv=None):
    """Run the CLI; returns the summary of the last recording written:
    ``{"path", "events", "stats", "frame_ts", "gt"}``."""
    args = build_parser().parse_args(argv)

    if args.frame_fps > args.fps:
        raise ConfigurationError(
            f"--frame_fps {args.frame_fps} exceeds the render rate "
            f"--fps {args.fps}; frames would duplicate")
    if args.num_sequences > 1:
        if args.texture is not None:
            raise ConfigurationError(
                "--texture with --num_sequences: each sequence draws its "
                "own texture from its seed")
        # Training-set factory: N recordings with per-sequence random
        # texture and motion (direction uniform, magnitude 0.5-1.5x the
        # given parameters), written as seq_%03d.h5 under output_path.
        os.makedirs(args.output_path, exist_ok=True)
        rng = np.random.default_rng(args.seed)
        for i in range(args.num_sequences):
            seq = os.path.join(args.output_path, f"seq_{i:03d}.h5")
            velocity, omega, div = (tuple(args.velocity), args.omega,
                                    args.divergence)
            if args.scene == "translate":
                speed = float(np.hypot(*args.velocity))
                mag = speed * rng.uniform(0.5, 1.5)
                ang = rng.uniform(0, 2 * np.pi)
                velocity = (mag * np.cos(ang), mag * np.sin(ang))
            else:
                omega = float(args.omega * rng.uniform(0.5, 1.5)
                              * rng.choice([-1.0, 1.0]))
                if args.scene == "similarity":
                    div = float(args.divergence * rng.uniform(0.5, 1.5)
                                * rng.choice([-1.0, 1.0]))
            summary = _run_one(args, seed=args.seed + i, output_path=seq,
                               fmt="h5", velocity=velocity, omega=omega,
                               divergence=div)
        return summary
    fmt = args.format or ("h5" if args.output_path.endswith(".h5") else
                          "memmap")
    return _run_one(args, seed=args.seed, output_path=args.output_path,
                    fmt=fmt, velocity=tuple(args.velocity), omega=args.omega,
                    divergence=args.divergence)


def _run_one(args, seed, output_path, fmt, velocity, omega,
             divergence=0.0):
    import torch

    from .._device import resolve_device
    from ..data_formats.event_packagers import hdf5_packager, memmap_packager
    from ..simulation.esim import (SimulatorConfig, affine_scene,
                                   load_texture, rotating_scene,
                                   simulate_scene, smooth_texture,
                                   translating_scene)

    device = resolve_device(args.device)
    # Independent streams for scene texture and sensor noise.
    root = torch.Generator().manual_seed(seed)
    tex_seed, sim_seed = torch.randint(0, 2 ** 62, (2,),
                                       generator=root).tolist()
    H, W = args.sensor
    if args.texture is not None:
        texture = load_texture(args.texture, (H, W))
    else:
        texture = smooth_texture(torch.Generator().manual_seed(tex_seed),
                                 (H, W), octaves=args.octaves, device=device)
    if args.scene == "translate":
        scene = translating_scene(texture, velocity, device=device)
    elif args.scene == "similarity":
        scene = affine_scene(texture, divergence=divergence, omega=omega,
                             device=device)
    else:
        scene = rotating_scene(texture, omega, device=device)

    cfg = SimulatorConfig(c_pos=args.c_pos, c_neg=args.c_neg,
                          sigma_c=args.sigma_c, refractory=args.refractory,
                          leak_rate_hz=args.leak_rate,
                          shot_rate_hz=args.shot_rate,
                          hot_pixel_fraction=args.hot_pixels,
                          hot_pixel_rate_hz=args.hot_pixel_rate,
                          max_noise_events_per_pixel=args.noise_slots)
    generator = (torch.Generator().manual_seed(sim_seed)
                 if (args.sigma_c > 0 or cfg.noise_std > 0
                     or cfg.has_noise_events()) else None)
    events, frames, frame_ts, flows = simulate_scene(
        scene, args.duration, args.fps, cfg, generator=generator)
    print(f"simulated {len(events)} events "
          f"({events.stats['num_pos']} pos / {events.stats['num_neg']} neg, "
          f"{events.stats['dropped']} dropped, "
          f"{events.stats.get('num_noise', 0)} noise)")

    if fmt == "h5":
        parent = os.path.dirname(os.path.abspath(output_path))
        os.makedirs(parent, exist_ok=True)
        pk = hdf5_packager(output_path)
    else:
        os.makedirs(output_path, exist_ok=True)
        pk = memmap_packager(output_path)
    with pk:  # error paths close handles / sweep spill files
        pk.set_data_available(num_images=1, num_flow=1)
        pk.package_events(events.xs.astype(np.int64),
                          events.ys.astype(np.int64), events.ts, events.ps)

        # Write frames/flow at the (coarser) output rate, picking the truly
        # nearest rendered sample for each requested stamp.
        n_out = max(2, int(round(args.duration * args.frame_fps)) + 1)
        out_ts = np.linspace(0.0, args.duration, n_out)
        hi = np.searchsorted(frame_ts, out_ts).clip(1, len(frame_ts) - 1)
        lo = hi - 1
        idx = np.where(out_ts - frame_ts[lo] <= frame_ts[hi] - out_ts, lo, hi)
        for k, i in enumerate(idx):
            frame8 = np.clip(frames[i] * 255.0, 0, 255).astype(np.uint8)
            pk.package_image(frame8, float(frame_ts[i]), img_idx=k)
            pk.package_flow(flows[i].astype(np.float32), float(frame_ts[i]),
                            flow_idx=k)

        n = len(events)
        t0 = float(events.ts[0]) if n else 0.0
        tk = float(events.ts[-1]) if n else 0.0
        pk.add_metadata(num_events=n, num_pos=events.stats["num_pos"],
                        num_neg=events.stats["num_neg"], duration=tk - t0,
                        t0=t0, tk=tk, num_imgs=len(idx), num_flow=len(idx),
                        sensor_size=(H, W))

    gt = {"scene": args.scene, "params": scene.params.tolist(),
          "sensor": [H, W], "duration": args.duration,
          "c_pos": args.c_pos, "c_neg": args.c_neg, "seed": seed}
    gt_path = (output_path + ".gt.json" if fmt == "h5"
               else os.path.join(output_path, "gt.json"))
    with open(gt_path, "w") as f:
        json.dump(gt, f, indent=1)
    print(f"wrote {fmt} dataset to {output_path} "
          f"(ground truth: {gt_path})")
    return {"path": output_path, "events": len(events),
            "stats": dict(events.stats),
            "frame_ts": frame_ts[idx].tolist(), "gt": gt}


if __name__ == "__main__":
    main()
