"""EV-FlowNet training (port of ``event_utils_tpu.training.loop``).

``FlowTrainer`` owns the model, ``torch.optim.Adam`` and the step count on
one device. One ``train_batch_async`` call is one optimisation step of
``contrast_flow_loss`` (plus the simulation-supervised AEE term when
``supervised_weight > 0``) on a ``(B, C, H, W)`` voxel batch and its padded
raw events, forward and backward with TF32 off (``_device.no_tf32``), as
the reference computes in f32.

The optimiser is optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root
0), which ``torch.optim.Adam`` computes with the same bias corrections.
``learning_rate`` is a float or a schedule of the number of updates already
applied (``cosine_decay_schedule``, optax's formula), so the first update
uses ``schedule(0)``; loading weights (``load_params``) starts a fresh
optimiser and so a fresh count, as in JAX.

``fit`` drives the streaming loaders through ``device_prefetch`` and
voxelizes each batch of B padded windows in one call
(``in_the_loop.voxelize_batch``: one batched voxel kernel launch under
``'pallas'``), as JAX vmaps a grid per window.

Data parallelism (``mesh=``, a ``parallel.make_mesh`` mesh): the model is
wrapped in ``DistributedDataParallel`` over the mesh's group, so the
weights and the Adam state stay replicated, and each rank trains on its
slice ``[r B/N, (r+1) B/N)`` of every global batch. DDP's mean of the
ranks' gradients is the gradient of the global batch, because every loss
of ``models.networks`` is a mean over equal shards and no network keeps
batch statistics. Every rank gets the global batch (or, with
``sharded=True``, its own slice), computes the same update, and reports
the global loss (the ranks' mean). A batch that does not divide over the
mesh raises ``ConfigurationError`` (JAX's sharding raises ``ValueError``).
Only rank 0 writes checkpoints and logs.

The orbax checkpoint is replaced by the port's own ``ckpt_dir`` format
(``training.checkpointing``).

``model_kwargs["architecture"]`` picks the network
(``models.networks.FLOW_MODELS``): absent, the port of the JAX package's
``EVFlowNet``, which predicts from one window (``predict``); ``"ERAFT"``,
E-RAFT (``models.eraft``), which predicts from a pair of consecutive
windows (``predict_pairs``) and is inference only here: the training
methods raise ``ConfigurationError`` for it. The key stays in
``model_kwargs``, so saved weights rebuild the same network.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Union

import torch

from .._device import as_f32, no_tf32, resolve_device
from ..data_loaders import prefetch
from ..errors import ConfigurationError
from ..models.networks import FLOW_MODELS, contrast_flow_loss
from ..parallel import sharding
from .in_the_loop import voxelize_batch

Schedule = Union[float, Callable[[int], float]]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5
    * (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``,
    ``count`` the number of updates already applied."""
    if decay_steps <= 0:
        raise ConfigurationError(
            f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        frac = min(int(count), decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(
            math.pi * frac)) + alpha)

    return schedule


class AdamStep:
    """``torch.optim.Adam`` over ``params`` with optax's defaults and a
    float or scheduled learning rate; shared by both trainers."""

    def __init__(self, params, learning_rate: Schedule):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.reset()

    def reset(self):
        """A fresh optimiser (zero moments, update count 0)."""
        self.optimizer = torch.optim.Adam(self.params, lr=self.lr(0),
                                          betas=(0.9, 0.999), eps=1e-8)

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @property
    def count(self) -> int:
        """Updates applied since the optimiser started."""
        state = self.optimizer.state.get(self.params[0])
        return int(state["step"]) if state else 0

    def minimize(self, loss):
        """One update from ``loss``'s gradients (any earlier ones are
        discarded first)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.step()

    def step(self):
        """One update from the gradients the parameters hold."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.count)
        self.optimizer.step()


def data_parallel(model: torch.nn.Module, mesh):
    """``model`` as it is called in training: itself, or wrapped in
    ``DistributedDataParallel`` over ``mesh``'s group."""
    if mesh is None:
        return model
    group, _, _ = sharding._axis(mesh, None)
    return torch.nn.parallel.DistributedDataParallel(model,
                                                     process_group=group)


class FlowTrainer:
    """Self-supervised EV-FlowNet trainer over padded event/voxel batches
    on one device, or data-parallel over a mesh.

    @param sensor_size (H, W) — divisible by 2^depth (pad with
        ``utils.util.CropParameters`` otherwise)
    @param learning_rate A float or a schedule (``cosine_decay_schedule``)
    @param seed Seed of the random initial weights (loading replaces them)
    @param mesh A ``parallel.make_mesh`` mesh: train data-parallel over its
        ranks, on this rank's device (``device`` is then not used)
    @param device Where the model runs: ``None`` means the card and raises
        ``DeviceUnavailableError`` without one; pass ``"cpu"`` for the host.
    @param model_kwargs The network (``"architecture"``: ``"EVFlowNet"``,
        the default, or ``"ERAFT"``) and its arguments (ERAFT's ``iters``);
        recorded in saved weights (``__model_json__``)
    """

    def __init__(self, sensor_size=(64, 64), num_bins: int = 5,
                 combined_channels: bool = False,
                 learning_rate: Schedule = 1e-4, seed: int = 0,
                 smoothness_weight: float = 0.5,
                 supervised_weight: float = 0.0, mesh=None, device=None,
                 model_kwargs: Optional[dict] = None):
        self.mesh = mesh
        self.device = (sharding.mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.sensor_size = tuple(sensor_size)
        self.num_bins = num_bins
        self.combined_channels = combined_channels
        self.smoothness_weight = float(smoothness_weight)
        self.supervised_weight = float(supervised_weight)
        self.model_kwargs = dict(model_kwargs or {})
        channels = num_bins if combined_channels else 2 * num_bins
        kwargs = dict(self.model_kwargs)
        arch = kwargs.pop("architecture", "EVFlowNet")
        if arch not in FLOW_MODELS:
            raise ConfigurationError(
                f"unknown architecture {arch!r}; one of {sorted(FLOW_MODELS)}")
        self.model = FLOW_MODELS[arch](in_channels=channels, seed=seed,
                                       **kwargs).to(self.device).eval()
        #: whether the network predicts from pairs of windows (ERAFT)
        self.takes_pairs = getattr(self.model, "takes_pairs", False)
        self.net = data_parallel(self.model, mesh)
        self.opt = AdamStep(self.model.parameters(), learning_rate)
        self.step = 0

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return sharding.is_writer(self.mesh)

    def shard(self, batch):
        """This rank's slice of a global batch (all of it without a
        mesh)."""
        return batch[sharding.shard_slice(self.mesh, batch.shape[0])]

    @property
    def optimizer(self) -> torch.optim.Adam:
        return self.opt.optimizer

    @property
    def inference_params(self):
        """The deliverable weights (a state dict): what ``predict`` uses."""
        return self.model.state_dict()

    def _single_window(self, what: str):
        if self.takes_pairs:
            raise ConfigurationError(
                f"{type(self.model).__name__} predicts from pairs of windows "
                f"(predict_pairs); {what} takes single-window networks")

    def loss(self, voxel, events, mask, gt_flow):
        """The training loss on one batch (differentiable; no step)."""
        self._single_window("training")
        flow = self.net(voxel)
        loss = contrast_flow_loss(flow, events, mask, self.sensor_size,
                                  smoothness_weight=self.smoothness_weight)
        if self.supervised_weight:
            # sim-supervised term: AEE against the (B, 2, H, W) field
            loss = loss + self.supervised_weight * torch.mean(
                torch.linalg.vector_norm(flow - gt_flow, dim=1))
        return loss

    def train_batch_async(self, voxel, events, mask, gt_flow=None,
                          sharded: bool = False):
        """One optimisation step on a ``(B, C, H, W)`` voxel batch and its
        raw padded events ``(B, N, 4)`` / mask ``(B, N)``. Returns the loss
        as a 0-d tensor on the device without waiting for it: convert with
        ``float()`` only where the value is needed.

        ``gt_flow`` (B, 2, H, W) feeds the supervised term; it is required
        when ``supervised_weight > 0`` and ignored (zeros) otherwise.
        Under a mesh the inputs are the global batch, of which this rank
        trains on its slice, or with ``sharded=True`` that slice already;
        the loss returned is the global batch's."""
        dev = self.device
        if not sharded:
            voxel, events, mask = map(self.shard, (voxel, events, mask))
            if gt_flow is not None:
                gt_flow = self.shard(gt_flow)
        voxel = as_f32(voxel, dev)
        if gt_flow is None:
            if self.supervised_weight:
                raise ConfigurationError("trainer has supervised_weight > 0;"
                                         " train_batch needs gt_flow")
            gt_flow = torch.zeros((voxel.shape[0], 2) + self.sensor_size,
                                  device=dev)
        with no_tf32():
            loss = self.loss(voxel, as_f32(events, dev), as_f32(mask, dev),
                             as_f32(gt_flow, dev))
            self.opt.minimize(loss)
        self.step += 1
        return sharding.all_reduce(loss.detach().clone(), self.mesh, "mean")

    def train_batch(self, voxel, events, mask, gt_flow=None) -> float:
        """Synchronous ``train_batch_async`` (returns the loss float)."""
        return float(self.train_batch_async(voxel, events, mask, gt_flow))

    @torch.no_grad()
    def predict(self, voxel) -> torch.Tensor:
        """``(B, 2, H, W)`` flow in px/s, on the trainer's device."""
        self._single_window("predict")
        return self.model(as_f32(voxel, self.device))

    @torch.no_grad()
    def predict_pairs(self, prev, cur):
        """``(flow (B, 2, H, W), flow8 (B, 2, H/8, W/8))`` on the trainer's
        device: ERAFT's displacement in pixels over the later window of each
        pair of ``(B, C, H, W)`` grids ``prev`` (the earlier windows) and
        ``cur``, upsampled and at 1/8 resolution."""
        if not self.takes_pairs:
            raise ConfigurationError(
                f"{type(self.model).__name__} predicts from single windows "
                "(predict)")
        return self.model(as_f32(prev, self.device),
                          as_f32(cur, self.device))

    # ------------------------------------------------------------------
    def load_params(self, path: str) -> int:
        """Load a ``params.npz`` (JAX's or the port's): weights replaced,
        optimiser started afresh, step set to the file's. Returns it."""
        from .checkpointing import load_params_npz
        return load_params_npz(self, path)

    def save_checkpoint(self, ckpt_dir: str):
        """Save model, optimiser and step under ``ckpt_dir`` (a second save
        of the same step does nothing; under a mesh rank 0 saves)."""
        from .checkpointing import save_trainer_checkpoint
        if self.is_writer:
            save_trainer_checkpoint(self, ckpt_dir)

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None):
        from .checkpointing import restore_trainer_checkpoint
        return restore_trainer_checkpoint(self, ckpt_dir, step)

    def fit(self, loader, epochs: int = 1, log_every: int = 10,
            ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
            prefetch_depth: int = 2, log_fn: Callable[[str], None] = print):
        """Train over a streaming loader (``NativeWindowedLoader``,
        ``H5WindowedLoader``, ``ChainLoader`` or ``EventDataLoader`` batches
        with ``events`` and ``events_mask``) for ``epochs`` passes, logging
        Mev/s ingested every ``log_every`` steps and saving a checkpoint
        every ``ckpt_every`` steps and at the end. Returns the losses.

        Batches reach the card through ``device_prefetch``, which stages
        each one into pinned memory at once; so unlike JAX's ``fit``, which
        clamps ``prefetch_depth`` to 2 to protect the loaders' rotating
        buffers from an upload still in flight, any depth is safe here.
        Losses stay on the device until a log point.

        Under a mesh every rank iterates the same loader (the same seed
        gives the same order) and uploads only its slice of each batch; the
        losses are the global batches', the rate counts every rank's
        events, and only rank 0 logs and saves.
        """
        self._single_window("training")
        keys = ("events", "events_mask")
        losses = []
        for epoch in range(epochs):
            batches = loader if self.mesh is None else (
                {k: self.shard(b[k]) for k in keys} for b in loader)
            t0 = time.perf_counter()
            n_epoch = torch.zeros((), dtype=torch.float64,
                                  device=self.device)
            pending = []  # device losses awaiting a log point
            for i, batch in enumerate(prefetch.device_prefetch(
                    batches, prefetch_depth=prefetch_depth,
                    device=self.device, keys=keys)):
                events = as_f32(batch["events"], self.device)
                mask = as_f32(batch["events_mask"], self.device)
                voxel = voxelize_batch(events, mask, self.num_bins,
                                       self.sensor_size,
                                       combined=self.combined_channels)
                pending.append(self.train_batch_async(voxel, events, mask,
                                                      sharded=True))
                n_epoch += mask.sum(dtype=torch.float64)
                if log_every and (i + 1) % log_every == 0:
                    losses.extend(float(x) for x in pending)
                    pending = []
                    n = sharding.all_reduce(n_epoch.clone(), self.mesh)
                    rate = float(n) / (time.perf_counter() - t0) / 1e6
                    if self.is_writer:
                        log_fn(f"epoch {epoch} step {self.step}: loss "
                               f"{losses[-1]:.5f}, {rate:.1f} Mev/s ingested")
                if ckpt_dir and self.step % ckpt_every == 0:
                    self.save_checkpoint(ckpt_dir)
            losses.extend(float(x) for x in pending)
        if ckpt_dir:
            self.save_checkpoint(ckpt_dir)
        return losses
