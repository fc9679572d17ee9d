"""Multi-card scaling on ``torch.distributed`` (port of
``event_utils_tpu.parallel.sharding``).

JAX runs one controller over a device ``Mesh`` and splits the work with
``shard_map``. PyTorch's idiom is SPMD: one process per card, each running
this same code under a process group (``torchrun``, or
``init_process_group`` in a spawned worker). A mesh here is a
one-dimensional ``DeviceMesh`` over that group, and every function below
runs on every rank:

- **Event sharding**: every rank is passed the whole stream, as JAX's
  callers pass global arrays. ``shard_events`` pads it with zeros (a zero
  mask included) to a multiple of the world size and keeps the rank's
  contiguous slice; each rank scatter-adds its slice with the port's
  single-card function (the CUDA kernel on the card), and one
  ``all_reduce`` SUM gives every rank the whole image, as JAX's ``psum``
  gives its replicated ``P()`` outputs. Time windows are masked global
  reductions (``all_reduce`` MIN/MAX) taken before the shard-local work,
  so padded events (``ts = 0``) take no part.
- **ROI sharding**: ``sharded_grid_cmax`` buckets on every rank and each
  rank solves its own rows of ROIs; the answers meet in one ``all_reduce``
  SUM of a zero-filled buffer that each rank writes its rows into.
- **The train step** differentiates through the reduction with
  ``_SumOverShards``: its forward is the ``all_reduce`` SUM of the
  per-shard image and its backward the identity, because the cotangent of
  a loss that every rank computes from the same replicated image is
  already replicated. One ``all_reduce`` SUM of the parameter gradient
  then gives every rank the whole gradient.
  ``torch.distributed.nn.functional.all_reduce`` must not be used there:
  its backward sums the replicated cotangent again and scales the
  gradient by the world size.

Only ``all_reduce`` and ``broadcast`` are used: gloo offers just those two
on CUDA tensors, so a mesh of several ranks on one card (gloo; NCCL
refuses two ranks on one device) runs the same code as NCCL over several
cards. gloo copies CUDA tensors through host memory inside the collective;
the port itself moves no tensor to the host.

JAX caches one compiled program per (mesh, configuration); the port has no
compile step and keeps no caches.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import as_f32, as_tensor, resolve_device, to_numpy
from ..errors import ConfigurationError

_BIG = torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def _default_device(device):
    """``device``; for ``None`` or ``"cuda"`` without an index, the card of
    this process's ``LOCAL_RANK`` (modulo the cards there are, so that
    ranks that outnumber the cards share them)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    return dev


def _backend(dev: torch.device, world: int) -> str:
    """NCCL for cards with a card per rank; gloo on the CPU and where the
    ranks outnumber the cards (NCCL refuses two ranks on one card)."""
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "events",
              device=None):
    """One-dimensional ``DeviceMesh`` named ``axis_name`` over the default
    process group, one rank per entry.

    The process group is the caller's where one is initialised
    (``init_process_group`` in a spawned worker). Otherwise it is made
    here: from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``) when that names more than one rank, else, with
    ``n_devices`` ``None`` or 1, a world of one from an in-process store.
    The backend is NCCL with a card per rank, else gloo (the CPU, or ranks
    sharing a card). ``n_devices`` other than the world size raises
    ``ConfigurationError``.

    ``device``: where this rank computes; ``None`` or ``"cuda"`` means
    ``cuda:LOCAL_RANK`` (``DeviceUnavailableError`` without a card),
    ``"cpu"`` the host. Several
    ranks on one card pass that card (``"cuda:0"``) under gloo.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = _default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        launched = int(os.environ.get("WORLD_SIZE", 1))
        if launched > 1:
            dist.init_process_group(_backend(dev, launched),
                                    init_method="env://")
        elif n_devices not in (None, 1):
            raise ConfigurationError(
                f"make_mesh({n_devices}): no process group is initialised, "
                "so the world holds one rank; launch the ranks with torchrun"
                " or init_process_group first")
        else:
            dist.init_process_group(_backend(dev, 1), store=dist.HashStore(),
                                    rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ConfigurationError(
            f"make_mesh({n_devices}): the process group's world size is "
            f"{world}; a mesh spans every rank")
    return DeviceMesh(dev.type, list(range(world)),
                      mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh, axis_name: Optional[str]):
    """``(group, size, rank)`` of this process along ``axis_name`` (the
    mesh's one dimension when ``None``)."""
    names = mesh.mesh_dim_names or ()
    if axis_name is None:
        axis_name = names[0]
    if axis_name not in names:
        raise ConfigurationError(f"mesh has no axis {axis_name!r}; its axes "
                                 f"are {names}")
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis_name)


def shard_slice(mesh, n: int, axis_name: Optional[str] = None) -> slice:
    """This rank's contiguous rows ``[r n/N, (r+1) n/N)`` of ``n``, which
    must divide by the mesh's size (``ConfigurationError`` otherwise); all
    ``n`` rows without a mesh (``None``)."""
    if mesh is None:
        return slice(0, n)
    _, size, rank = _axis(mesh, axis_name)
    if n % size:
        raise ConfigurationError(f"a batch of {n} does not divide over the "
                                 f"mesh's {size} ranks")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def is_writer(mesh) -> bool:
    """Whether this process writes files and logs: rank 0, or no mesh."""
    return mesh is None or dist.get_rank() == 0


def all_reduce(t: torch.Tensor, mesh, op: str = "sum",
               axis_name: Optional[str] = None) -> torch.Tensor:
    """``t`` reduced over ``mesh`` in place (``"sum"``, ``"min"``,
    ``"max"`` or ``"mean"``); returns it (unchanged without a mesh)."""
    if mesh is None:
        return t
    group, size, _ = _axis(mesh, axis_name)
    ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=group)
    if op == "mean":
        t /= size
    return t


class _SumOverShards(torch.autograd.Function):
    """``all_reduce`` SUM whose backward is the identity: the cotangent of
    a loss computed alike on every rank from the reduced tensor is already
    replicated, so summing it again would scale the gradient by the world
    size."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# Event sharding
# ---------------------------------------------------------------------------

def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0):
    """``arr`` (a tensor) padded along ``axis`` with ``fill`` to a multiple
    of ``multiple``; returns ``(arr, orig_len)``."""
    n = arr.shape[axis]
    extra = -n % multiple
    if not extra:
        return arr, n
    shape = list(arr.shape)
    shape[axis] = extra
    pad = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=axis), n


def shard_events(mesh, xs, ys, ts, ps, mask=None, axis_name="events"):
    """This rank's contiguous slice ``(xs, ys, ts, ps, mask)`` of the whole
    stream padded with zeros (mask included) to a multiple of the mesh's
    size, as float32 tensors on the rank's device. Only the slice is
    converted and moved there."""
    _, size, rank = _axis(mesh, axis_name)
    dev = mesh_device(mesh)
    n = len(xs)
    per = -(-n // size)
    lo, hi = min(rank * per, n), min((rank + 1) * per, n)
    out = []
    for a in (xs, ys, ts, ps, mask):
        part = (torch.ones(hi - lo, device=dev) if a is None
                else as_f32(a[lo:hi], dev))
        out.append(torch.nn.functional.pad(part, (0, per - (hi - lo))))
    return tuple(out)


def _masked_min_max(ts, mask, mesh, axis_name, want=("min", "max")):
    """Global min and/or max of the stamps of valid events."""
    on = mask != 0
    out = []
    for op in want:
        fill = _BIG if op == "min" else -_BIG
        local = torch.where(on, ts, fill)
        local = (local.amin() if op == "min" else local.amax()) \
            if local.numel() else torch.tensor(fill, device=ts.device)
        out.append(all_reduce(local.clone(), mesh, op, axis_name))
    return out


def sharded_events_to_voxel(mesh, xs, ys, ts, ps, B: int,
                            sensor_size=(180, 240), mask=None,
                            axis_name: str = "events",
                            temporal_bilinear: bool = True,
                            impl: Optional[str] = None):
    """Voxel grid ``(B, H, W)`` of a stream sharded over the mesh: the
    global window (t0, t1) of the valid events first, then each rank's
    grid of its slice (``events_to_voxel``, the voxel kernel on the card),
    then one ``all_reduce`` SUM."""
    from ..representations.voxel_grid import events_to_voxel

    xs, ys, ts, ps, mask = shard_events(mesh, xs, ys, ts, ps, mask,
                                        axis_name)
    t0, t1 = _masked_min_max(ts, mask, mesh, axis_name)
    vox = events_to_voxel(xs, ys, ts, ps, B, sensor_size=sensor_size,
                          temporal_bilinear=temporal_bilinear, mask=mask,
                          t0=t0, t1=t1, impl=impl)
    return all_reduce(vox, mesh, "sum", axis_name)


def _sharded_iwe_local(mesh, params, xs, ys, ts, ps, mask, warpfunc,
                       img_size, use_polarity, axis_name):
    """This rank's IWE of its (already sharded) events at the global
    reference time: the last valid stamp."""
    from ..contrast_max.events_cmax import DEFAULT_IWE_IMPL
    from ..models.objectives import get_iwe

    (t0,) = _masked_min_max(ts, mask, mesh, axis_name, want=("max",))
    iwe, _ = get_iwe(params, xs, ys, ts, ps, warpfunc, img_size,
                     use_polarity=use_polarity, mask=mask, t0=t0,
                     impl=DEFAULT_IWE_IMPL)
    return iwe


def sharded_iwe(mesh, params, xs, ys, ts, ps, warpfunc, img_size,
                mask=None, axis_name: str = "events", use_polarity=True):
    """Image of warped events over a sharded stream, ``all_reduce``-summed;
    differentiable in ``params`` (each rank's gradient is its shard's
    part: sum them over the mesh, as ``make_sharded_cmax_train_step``
    does). Each shard's image is the bilinear kernel on the card
    (``iwe_impl='matmul'``, the port's cmax default; JAX's host path
    scatters with XLA: the same f32 sums)."""
    group, _, _ = _axis(mesh, axis_name)
    xs, ys, ts, ps, mask = shard_events(mesh, xs, ys, ts, ps, mask,
                                        axis_name)
    params = as_f32(params, xs.device)
    iwe = _sharded_iwe_local(mesh, params, xs, ys, ts, ps, mask, warpfunc,
                             img_size, use_polarity, axis_name)
    return _SumOverShards.apply(iwe, group)


def sharded_events_to_timestamp_image(mesh, xs, ys, ts, ps,
                                      sensor_size=(180, 240), mask=None,
                                      padding: bool = True,
                                      timestamp_reverse: bool = False,
                                      axis_name: str = "events",
                                      impl: Optional[str] = None):
    """Average-timestamp images (Zhu CVPR'19) over a sharded stream.

    Each pixel is a ratio of global sums, so every rank accumulates the
    four raw channels of its slice (``_timestamp_weight_sums``: ts*pos,
    pos, ts*neg, neg, one bilinear launch), one ``all_reduce`` SUM joins
    them and the division happens once, after it. Stamps are normalised
    by the global window of the valid events. Returns ``(img_pos,
    img_neg)``."""
    from ..representations.image import _timestamp_weight_sums

    H, W = sensor_size
    xs, ys, ts, ps, mask = shard_events(mesh, xs, ys, ts, ps, mask,
                                        axis_name)
    img_size = (H + 1, W + 1) if padding else (H, W)
    clipx, clipy = img_size[1] - 1, img_size[0] - 1
    t_first, t_last = _masked_min_max(ts, mask, mesh, axis_name)
    eps = 1e-6
    if timestamp_reverse:
        tn = (-ts + t_last) / (t_last - t_first + eps)
    else:
        tn = (ts - t_first) / (t_last - t_first + eps)
    stack = _timestamp_weight_sums(xs, ys, tn, ps, mask, img_size, clipx,
                                   clipy, True, False, impl)
    stack = all_reduce(stack.contiguous(), mesh, "sum", axis_name)
    img_pos = stack[0] / torch.clamp(1.0 + stack[1], min=1.0)
    img_neg = stack[2] / torch.clamp(1.0 + stack[3], min=1.0)
    return img_pos, img_neg


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def make_sharded_cmax_train_step(mesh, objective, warpfunc, img_size,
                                 blur_sigma: float = 1.0, lr: float = 0.5,
                                 momentum: float = 0.9, normalize_grad=True,
                                 axis_name: str = "events"):
    """One SGD-with-momentum update of contrast maximisation over sharded
    events: ``step(params, mom, xs, ys, ts, ps, mask) -> (params, mom,
    loss)`` over this rank's slices (``shard_events``), with ``params`` and
    ``mom`` replicated.

    The loss is the objective of the summed, blurred IWE; its gradient
    flows through ``_SumOverShards`` to this rank's events, and one
    ``all_reduce`` SUM of it gives every rank the whole gradient.
    ``normalize_grad`` divides it by its norm, as JAX's step does.
    """
    from ..ops.blur import gaussian_filter

    group, _, _ = _axis(mesh, axis_name)

    def step(params, mom, xs, ys, ts, ps, mask):
        params = params.detach().clone().requires_grad_(True)
        iwe = _sharded_iwe_local(mesh, params, xs, ys, ts, ps, mask,
                                 warpfunc, img_size, objective.use_polarity,
                                 axis_name)
        iwe = _SumOverShards.apply(iwe, group)
        if blur_sigma and blur_sigma > 0:
            iwe = gaussian_filter(iwe, blur_sigma)
        loss = objective.loss_fn(iwe)
        (grad,) = torch.autograd.grad(loss, params)
        grad = all_reduce(grad.contiguous(), mesh, "sum", axis_name)
        if normalize_grad:
            grad = grad / (torch.linalg.vector_norm(grad) + 1e-12)
        mom = momentum * mom + grad
        return (params - lr * mom).detach(), mom, loss.detach()

    return step


def sharded_cmax_train_step(mesh, params, opt_state, xs, ys, ts, ps,
                            objective, warpfunc, img_size, mask=None,
                            blur_sigma: float = 1.0, lr: float = 0.5,
                            axis_name: str = "events"):
    """One update of ``make_sharded_cmax_train_step`` on a whole stream:
    shards the events, starts the momentum at zero when ``opt_state`` is
    ``None``. Returns ``(params, momentum, loss)``."""
    step = make_sharded_cmax_train_step(mesh, objective, warpfunc, img_size,
                                        blur_sigma=blur_sigma, lr=lr,
                                        axis_name=axis_name)
    xs, ys, ts, ps, mask = shard_events(mesh, xs, ys, ts, ps, mask,
                                        axis_name)
    params = as_f32(params, xs.device)
    mom = (torch.zeros_like(params) if opt_state is None
           else as_f32(opt_state, xs.device))
    return step(params, mom, xs, ys, ts, ps, mask)


# ---------------------------------------------------------------------------
# ROI sharding
# ---------------------------------------------------------------------------

def sharded_grid_cmax(mesh, xs, ys, ts, ps, roi_size=(20, 20),
                      img_size=None, warp=None, obj=None,
                      min_events: int = 10,
                      blur_sigma: float = 1.0, maxiter: int = 50,
                      capacity: Optional[int] = None,
                      axis_name: str = "events"):
    """``grid_cmax`` with the ROI axis sharded: every rank buckets the
    whole stream (``bucket_events_by_roi``), pads the R ROIs to a multiple
    of the mesh's size and solves its own contiguous rows with the batched
    ROI solver ``grid_cmax_batched`` uses (``make_roi_solve_one``); one
    ``all_reduce`` SUM of a zero-filled ``(R_pad, dims + 1)`` buffer, each
    rank writing its rows, gives every rank every answer.

    Returns ``grid_cmax_batched``'s contract: ``(params (R, dims), rois (R,
    4), f_evals (R,), valid (R,))`` with the same ``min_events`` gate.
    """
    from ..contrast_max.events_cmax import (bucket_events_by_roi,
                                            make_roi_solve_one)
    from ..models.objectives import variance_objective
    from ..models.warps import linvel_warp
    from ..utils.event_util import infer_resolution

    _, size, rank = _axis(mesh, axis_name)
    dev = mesh_device(mesh)
    warp = linvel_warp() if warp is None else warp
    obj = variance_objective() if obj is None else obj
    xs, ys, ts, ps = map(to_numpy, (xs, ys, ts, ps))
    resolution = infer_resolution(xs, ys) if img_size is None else img_size
    resolution = tuple(int(v) for v in resolution)
    rh, rw = roi_size

    bx, by, bt, bp, bmask, origins, _ = bucket_events_by_roi(
        xs, ys, ts, ps, resolution, roi_size, capacity, device=dev)
    R = bx.shape[0]
    rows = [pad_to_multiple(a, size)[0] for a in
            (bx, by, bt, bp, bmask, origins.to(torch.float32))]
    per = rows[0].shape[0] // size
    mine = slice(rank * per, (rank + 1) * per)
    solve = make_roi_solve_one(warp, obj, resolution, tuple(roi_size),
                               blur_sigma, maxiter)
    params, f_evals = solve(*(a[mine] for a in rows))
    dims = params.shape[-1]
    answers = torch.zeros((rows[0].shape[0], dims + 1), device=dev)
    answers[mine, :dims] = params
    answers[mine, dims] = f_evals
    answers = all_reduce(answers, mesh, "sum", axis_name)
    rois = torch.cat([origins, as_tensor(np.array([[rh, rw]]), dev)
                      .to(origins.dtype).expand(R, 2)], dim=-1)
    return (answers[:R, :dims], rois, answers[:R, dims],
            bmask.sum(1) > min_events)
