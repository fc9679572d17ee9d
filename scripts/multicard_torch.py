#!/usr/bin/env python3
"""The port's multi-card path on N cards, one process per card.

    torchrun --nproc_per_node N scripts/multicard_torch.py [--device cpu]
        [--dp_steps 5]

Every rank joins the launched group through ``parallel.make_mesh`` (NCCL
with a card per rank; gloo on the CPU or where ranks share a card) and
runs ``chip_smoke.sharded_suite`` on the smoke's streams: the sharded
voxel grid (2^21 events, DAVIS240, B=5), IWE and timestamp image (the
200k-event planted scene), 3 steps of the sharded train step with
``normalize_grad`` on and off, and ``sharded_grid_cmax`` on the rotating
scene. Rank 0 holds each result against the single-card function on its
own card by the smoke's rules (1e-5 of the scale; the ROI solve's flow
error within 4.5 px/s and each ROI's loss within 1e-4 of the single
card's loss at its answer). Then it times, in ms (medians of 5
synchronised calls on every rank):

- each sharded call from host numpy (every rank is handed the whole
  stream, as JAX's callers hand global arrays) and from tensors already
  on each rank's card, beside its ``all_reduce`` alone;
- the sharded train step;

and the data-parallel flow trainer in the loop (``train_flow --simulate``'s
stage-9 recipe: 128x128, similarity scenes, the committed weights) at a
global batch of 8 and of 8 per rank: steps/s and M events/s over
``--dp_steps`` steps after one warm step.

Rank 0 prints the card line and one JSON line. Any disagreement raises.
Run it with ``--nproc_per_node 1`` beside the N-rank run to compare.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def dp_rate(torch, mesh, batch, steps):
    """Steps/s and M events/s of data-parallel in-the-loop training at a
    global ``batch``, over ``steps`` steps after a warm one."""
    import chip_smoke as smoke
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                train_flow_in_the_loop)
    kw = dict(batch_size=batch, capacity=65536, v_max=40.0, window_t=0.1,
              num_frames=9, omega_max=6.0, s_max=0.6, burn_in=1,
              fresh_prob=0.25, age_max=2.5, eval_every=0, log_every=0,
              seed=smoke.TRAIN_SEED, log_fn=lambda s: None)
    t = FlowTrainer((128, 128), learning_rate=5e-6, supervised_weight=1.0,
                    mesh=mesh)
    t.load_params(smoke.FLOW_PARAMS)
    train_flow_in_the_loop(t, steps=1, **kw)
    stats = {}
    losses, _ = train_flow_in_the_loop(t, steps=steps, stats=stats, **kw)
    if not np.isfinite(losses).all():
        raise AssertionError(f"data parallel at batch {batch}: {losses}")
    return {"global_batch": batch, "steps_per_s": steps / stats["wall_s"],
            "mev_per_s": stats["events"] / stats["wall_s"] / 1e6,
            "sim_share": stats["sim_s"] / stats["wall_s"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (a card per rank) or 'cpu'")
    parser.add_argument("--dp_steps", type=int, default=5)
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    import chip_smoke as smoke
    from event_utils_tpu_torch.parallel import make_mesh, sharding

    mesh = make_mesh(device=args.device)
    dev = sharding.mesh_device(mesh)
    world, rank = dist.get_world_size(), dist.get_rank()
    out, ms = smoke.sharded_suite(torch, mesh, dev)
    report = {"world": world, "backend": dist.get_backend(),
              "ms_from_host": ms}
    if rank == 0:
        report["errors"] = single_card_errors(torch, smoke, out, dev)

    # the same calls on streams already on every rank's card
    from event_utils_tpu_torch import parallel as par
    from event_utils_tpu_torch.models import linvel_warp
    inp = smoke.par_inputs()
    on = {k: [torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in v] for k, v in inp.items()}
    calls = {
        "voxel": lambda: par.sharded_events_to_voxel(
            mesh, *on["voxel"], smoke.B, sensor_size=smoke.SENSOR,
            impl="matmul"),
        "iwe": lambda: par.sharded_iwe(
            mesh, np.float32(smoke.VELOCITY), *on["planted"], linvel_warp(),
            smoke.SENSOR).detach(),
        "tsimg": lambda: par.sharded_events_to_timestamp_image(
            mesh, *on["planted"], sensor_size=smoke.SENSOR,
            impl="matmul")[0],
    }
    report["ms_on_card"] = {k: smoke.sync_ms(torch, dev, fn)
                            for k, fn in calls.items()}
    dp_mesh = make_mesh(axis_name="batch", device=args.device)
    report["data_parallel"] = [dp_rate(torch, dp_mesh, b, args.dp_steps)
                               for b in (8, 8 * world)]
    if rank == 0:
        print(smoke.card_line() if dev.type == "cuda" else "CPU", flush=True)
        print(json.dumps({"multicard": report}), flush=True)
    dist.destroy_process_group()
    return 0


def single_card_errors(torch, smoke, out, dev):
    """Rank 0's sharded results against the single-card functions on its
    card, by the smoke's rules; raises on a disagreement."""
    from event_utils_tpu_torch.models import get_iwe, linvel_warp
    from event_utils_tpu_torch.representations import (
        events_to_timestamp_image, events_to_voxel)
    inp = smoke.par_inputs()
    vx, vy, vt, vp = inp["voxel"]
    px, py, pt, pp = inp["planted"]
    single = {
        "voxel": events_to_voxel(vx, vy, vt, vp, smoke.B,
                                 sensor_size=smoke.SENSOR, impl="matmul",
                                 device=dev),
        "iwe": get_iwe(np.float32(smoke.VELOCITY), px, py, pt, pp,
                       linvel_warp(), smoke.SENSOR, impl="matmul",
                       device=dev)[0],
        "tsimg": torch.stack(events_to_timestamp_image(
            px, py, pt, pp, sensor_size=smoke.SENSOR, impl="matmul",
            device=dev))}
    errs = {k: smoke.check_close(f"sharded {k} vs single card", out[k], v,
                                 rel=smoke.PAR_REL)
            for k, v in single.items()}
    ev = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
          for a in inp["planted"]]
    for norm in (1, 0):
        p = torch.tensor(smoke.PAR_P0, device=dev)
        m = torch.zeros(2, device=dev)
        hist = []
        for _ in range(smoke.PAR_STEPS):
            p, m, loss = smoke.reference_cmax_step(torch, p, m, *ev, norm)
            hist.append(torch.cat([p, m, loss[None]]))
        errs[f"step_{norm}"] = smoke.check_steps(
            f"sharded train steps, normalize_grad={bool(norm)}",
            out[f"step_{norm}"], torch.stack(hist))
    err, n = smoke.flow_error(out["grid_params"], out["grid_rois"],
                              out["grid_valid"])
    at = smoke.roi_losses_at(torch, out["grid_params"], dev)
    lrel = float(((out["grid_f"] - at).abs()
                  / at.abs().clamp(min=1e-12)).max())
    smoke.log(f"  sharded_grid_cmax: flow error {err:.3f} px/s over {n} "
              f"ROIs; each ROI's loss at its answer, max rel {lrel:.3e}")
    if not (err <= smoke.FLOW_ERR_LIMIT and lrel <= smoke.PAR_ROI_LOSS_REL):
        raise AssertionError(f"sharded_grid_cmax: {err}, {lrel}")
    errs.update(flow_error=err, roi_loss_rel=lrel)
    return errs


if __name__ == "__main__":
    sys.exit(main())
