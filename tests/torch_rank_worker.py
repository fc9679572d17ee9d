"""Ranks of the port's multi-card tests, run on the CPU under gloo.

    python tests/torch_rank_worker.py WORLD OUT_DIR [FLOW_INIT_NPZ]

spawns WORLD ranks (``torch.multiprocessing``, a ``file://`` store in
OUT_DIR, so concurrent runs never share a port); each builds a mesh over
the group, runs every sharded function and data-parallel trainer of the
port on the inputs of ``make_inputs`` and writes what it got to
``OUT_DIR/rank<r>.npz``. ``tests/test_torch_parallel.py`` runs it and holds
the results against the JAX package and the one-process port. Imports
torch and the port only.
"""

import os
import sys

import numpy as np

# the spawned ranks import this file as their main module
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SENSOR = (24, 32)
TRAIN_HW = (32, 32)
TRAIN_BATCH = 6             # divides over 2 and 3 ranks
TRAIN_STEPS = 2
LOOP_KW = dict(batch_size=6, capacity=4096, log_every=1, eval_every=2,
               seed=5)
FLOW_LOOP_KW = dict(omega_max=6.0, s_max=0.6, burn_in=1, fresh_prob=0.25,
                    age_max=2.5)
RECON_KW = {"base_features": 8, "recurrent_levels": 3, "num_res_blocks": 1}
RECON_LOOP_KW = dict(seq_len=3, carry_segments=2)
STEP_CASES = {"normalized": True, "raw": False}


def make_events(rng, n, sensor=SENSOR, int_coords=True, t_max=0.5):
    """``tests/conftest.py``'s random stream (sorted stamps)."""
    H, W = sensor
    if int_coords:
        xs = rng.integers(0, W, n).astype(np.int64)
        ys = rng.integers(0, H, n).astype(np.int64)
    else:
        xs = rng.uniform(0, W - 1, n)
        ys = rng.uniform(0, H - 1, n)
    ts = np.sort(rng.uniform(0, t_max, n))
    ps = rng.choice(np.array([-1.0, 1.0]), n)
    return xs, ys, ts, ps


def flow_scene(rng, vx, vy, n_events, sensor, n_points=25, t_max=1.0,
               noise=0.1):
    """Points moving with a planted velocity (``tests/test_torch_roi.py``'s
    scene)."""
    H, W = sensor
    mx = abs(vx) * t_max + 2
    my = abs(vy) * t_max + 2
    px = rng.uniform(mx if vx < 0 else 2, W - 2 - (mx if vx > 0 else 0),
                     n_points)
    py = rng.uniform(my if vy < 0 else 2, H - 2 - (my if vy > 0 else 0),
                     n_points)
    pol = rng.choice([-1.0, 1.0], n_points)
    idx = rng.integers(0, n_points, n_events)
    ts = np.sort(rng.uniform(0, t_max, n_events))
    xs = px[idx] + vx * ts + rng.normal(0, noise, n_events)
    ys = py[idx] + vy * ts + rng.normal(0, noise, n_events)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return xs[keep], ys[keep], ts[keep], pol[idx][keep]


def flow_batches():
    """Fixed ``(voxel, events, mask, gt)`` batches of TRAIN_BATCH at
    TRAIN_HW."""
    H, W = TRAIN_HW
    g = np.random.default_rng(21)
    out = []
    for _ in range(TRAIN_STEPS):
        B, N = TRAIN_BATCH, 800
        ev = np.stack([g.integers(0, W, (B, N)), g.integers(0, H, (B, N)),
                       np.sort(g.uniform(0, 0.1, (B, N)), 1),
                       g.choice([-1.0, 1.0], (B, N))], -1).astype(np.float32)
        mask = (g.uniform(size=(B, N)) < 0.9).astype(np.float32)
        vox = g.normal(size=(B, 10, H, W)).astype(np.float32)
        gt = (g.normal(size=(B, 2, H, W)) * 30).astype(np.float32)
        out.append((vox, ev, mask, gt))
    return out


def make_inputs():
    """Every input of the sharded functions, from fixed seeds."""
    ts_rng = np.random.default_rng(7)
    n = 4000
    return {
        "voxel": make_events(np.random.default_rng(42), 4096),
        "voxel_ragged": make_events(np.random.default_rng(43), 4001),
        "iwe": make_events(np.random.default_rng(44), 2048,
                           int_coords=False),
        "iwe_params": np.array([5.0, -3.0], np.float32),
        "tsimg": (ts_rng.uniform(0, SENSOR[1] - 1, n).astype(np.float32),
                  ts_rng.uniform(0, SENSOR[0] - 1, n).astype(np.float32),
                  np.sort(ts_rng.uniform(0, 0.4, n)).astype(np.float32),
                  ts_rng.choice(np.array([-1.0, 1.0], np.float32), n)),
        "step": make_events(np.random.default_rng(45), 4096,
                            int_coords=False),
        "step_params": np.array([3.0, -2.0], np.float32),
        "grid": flow_scene(np.random.default_rng(0), 10.0, 5.0, 6000,
                           SENSOR),
        "grid_kw": dict(roi_size=(12, 16), img_size=SENSOR, maxiter=15,
                        capacity=2048),
    }


def state_arrays(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def run_rank(rank, world, out_dir, flow_init):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "store"), rank=rank, world_size=world)
    from event_utils_tpu_torch.errors import ConfigurationError
    from event_utils_tpu_torch.models import linvel_warp, variance_objective
    from event_utils_tpu_torch.parallel import (
        make_mesh, make_sharded_cmax_train_step, shard_events,
        sharded_events_to_timestamp_image, sharded_events_to_voxel,
        sharded_grid_cmax, sharded_iwe)
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer,
                                                train_flow_in_the_loop,
                                                train_reconstruction_in_the_loop)
    from event_utils_tpu_torch.training import in_the_loop as itl

    mesh = make_mesh(world, device="cpu")
    inp = make_inputs()
    out = {}
    out["voxel"] = sharded_events_to_voxel(
        mesh, *inp["voxel"], 5, sensor_size=SENSOR).numpy()
    out["voxel_ragged"] = sharded_events_to_voxel(
        mesh, *inp["voxel_ragged"], 3, sensor_size=SENSOR).numpy()
    out["iwe"] = sharded_iwe(mesh, inp["iwe_params"], *inp["iwe"],
                             linvel_warp(), SENSOR).detach().numpy()
    for rev in (False, True):
        pos, neg = sharded_events_to_timestamp_image(
            mesh, *inp["tsimg"], sensor_size=SENSOR, timestamp_reverse=rev)
        out[f"tsimg_{rev:d}"] = np.stack([pos.numpy(), neg.numpy()])
    shards = shard_events(mesh, *inp["step"])
    for name, norm in STEP_CASES.items():
        step = make_sharded_cmax_train_step(
            mesh, variance_objective(), linvel_warp(), SENSOR,
            normalize_grad=norm)
        p = torch.as_tensor(inp["step_params"])
        m = torch.zeros(2)
        for i in range(TRAIN_STEPS):
            p, m, loss = step(p, m, *shards)
            out[f"step_{name}_{i}"] = np.concatenate(
                [p.numpy(), m.numpy(), [float(loss)]])
    params, rois, f_evals, valid = sharded_grid_cmax(mesh, *inp["grid"],
                                                     **inp["grid_kw"])
    out.update(grid_params=params.numpy(), grid_rois=rois.numpy(),
               grid_f=f_evals.numpy(), grid_valid=valid.numpy())

    # data parallel: FlowTrainer on fixed batches, from JAX's weights
    flow_mesh = make_mesh(world, axis_name="batch", device="cpu")
    if flow_init:
        t = FlowTrainer(TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0,
                        mesh=flow_mesh)
        t.load_params(flow_init)
        losses = []
        for i, batch in enumerate(flow_batches()):
            losses.append(t.train_batch(*batch))
            if i == 0:   # the first step's gradient, DDP's mean
                out.update({"dp_grad/" + n: p.grad.numpy().copy()
                            for n, p in t.model.named_parameters()})
        out["dp_losses"] = np.array(losses)
        out.update({"dp/" + k: v for k, v in state_arrays(t.model).items()})
        odd = [a[:world + 1] for a in flow_batches()[0]]
        try:
            t.train_batch(*odd)
            out["dp_odd_batch_raised"] = np.array(False)
        except ConfigurationError:
            out["dp_odd_batch_raised"] = np.array(True)
    # in the loop: the same scenes and weights as one process
    ft = FlowTrainer(TRAIN_HW, learning_rate=1e-3, supervised_weight=1.0,
                     mesh=flow_mesh)
    stats = {}
    losses, aee = train_flow_in_the_loop(ft, steps=TRAIN_STEPS,
                                         stats=stats, log_fn=lambda s: None,
                                         **LOOP_KW, **FLOW_LOOP_KW)
    ev, mask, gt = itl.simulate_flow_batch(
        LOOP_KW["seed"], 0, LOOP_KW["batch_size"], TRAIN_HW,
        LOOP_KW["capacity"], burn_in=1, omega_max=6.0, s_max=0.6,
        fresh_prob=0.25, age_max=2.5,
        elements=itl._elements(ft, LOOP_KW["batch_size"]), device="cpu")
    out.update(itl_flow_losses=np.array(losses), itl_flow_aee=np.array(aee),
               itl_flow_events=np.array(stats["events"]),
               itl_flow_scene_events=ev.numpy(),
               itl_flow_scene_mask=mask.numpy())
    out.update({"itl_flow/" + k: v for k, v in state_arrays(ft.model).items()})
    rt = ReconstructionTrainer(TRAIN_HW, learning_rate=1e-3, burn_in=1,
                               model_kwargs=RECON_KW, ema_decay=0.9,
                               mesh=flow_mesh)
    losses, curve = train_reconstruction_in_the_loop(
        rt, steps=2 * RECON_LOOP_KW["carry_segments"], log_fn=lambda s: None,
        **LOOP_KW, **RECON_LOOP_KW)
    out.update(itl_recon_losses=np.array(losses),
               itl_recon_curve=np.array(curve))
    out.update({"itl_recon/" + k: v
                for k, v in state_arrays(rt.ema_model).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def main(argv):
    import torch.multiprocessing as mp

    world, out_dir = int(argv[0]), argv[1]
    flow_init = argv[2] if len(argv) > 2 else ""
    mp.spawn(run_rank, args=(world, out_dir, flow_init), nprocs=world)


if __name__ == "__main__":
    main(sys.argv[1:])
