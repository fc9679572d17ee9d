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

Not ported: the mesh (``--data_parallel``, ``ROADMAP.md`` queue 1 item 6)
and ``fit`` over the streaming loaders, which waits for them (queue 1 item
2). The orbax checkpoint is replaced by the port's own ``ckpt_dir`` format
(``training.checkpointing``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from .._device import as_f32, no_tf32, resolve_device
from ..errors import ConfigurationError
from ..models.networks import EVFlowNet, contrast_flow_loss

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


class FlowTrainer:
    """Self-supervised EV-FlowNet trainer over padded event/voxel batches
    on one device.

    @param sensor_size (H, W) — divisible by 2^depth (pad with
        ``utils.util.CropParameters`` otherwise)
    @param learning_rate A float or a schedule (``cosine_decay_schedule``)
    @param seed Seed of the random initial weights (loading replaces them)
    @param device Where the model runs: ``None`` means the card and raises
        ``DeviceUnavailableError`` without one; pass ``"cpu"`` for the host.
    """

    def __init__(self, sensor_size=(64, 64), num_bins: int = 5,
                 combined_channels: bool = False,
                 learning_rate: Schedule = 1e-4, seed: int = 0,
                 smoothness_weight: float = 0.5,
                 supervised_weight: float = 0.0, device=None):
        self.device = resolve_device(device)
        self.sensor_size = tuple(sensor_size)
        self.num_bins = num_bins
        self.combined_channels = combined_channels
        self.smoothness_weight = float(smoothness_weight)
        self.supervised_weight = float(supervised_weight)
        self.model_kwargs = {}
        channels = num_bins if combined_channels else 2 * num_bins
        self.model = EVFlowNet(in_channels=channels, seed=seed).to(
            self.device).eval()
        self.opt = AdamStep(self.model.parameters(), learning_rate)
        self.step = 0

    @property
    def optimizer(self) -> torch.optim.Adam:
        return self.opt.optimizer

    @property
    def inference_params(self):
        """The deliverable weights (a state dict): what ``predict`` uses."""
        return self.model.state_dict()

    def loss(self, voxel, events, mask, gt_flow):
        """The training loss on one batch (differentiable; no step)."""
        flow = self.model(voxel)
        loss = contrast_flow_loss(flow, events, mask, self.sensor_size,
                                  smoothness_weight=self.smoothness_weight)
        if self.supervised_weight:
            # sim-supervised term: AEE against the (B, 2, H, W) field
            loss = loss + self.supervised_weight * torch.mean(
                torch.linalg.vector_norm(flow - gt_flow, dim=1))
        return loss

    def train_batch_async(self, voxel, events, mask, gt_flow=None):
        """One optimisation step on a ``(B, C, H, W)`` voxel batch and its
        raw padded events ``(B, N, 4)`` / mask ``(B, N)``. Returns the loss
        as a 0-d tensor on the device without waiting for it: convert with
        ``float()`` only where the value is needed.

        ``gt_flow`` (B, 2, H, W) feeds the supervised term; it is required
        when ``supervised_weight > 0`` and ignored (zeros) otherwise."""
        dev = self.device
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
        return loss.detach()

    def train_batch(self, voxel, events, mask, gt_flow=None) -> float:
        """Synchronous ``train_batch_async`` (returns the loss float)."""
        return float(self.train_batch_async(voxel, events, mask, gt_flow))

    @torch.no_grad()
    def predict(self, voxel) -> torch.Tensor:
        """``(B, 2, H, W)`` flow in px/s, on the trainer's device."""
        return self.model(as_f32(voxel, self.device))

    # ------------------------------------------------------------------
    def load_params(self, path: str) -> int:
        """Load a ``params.npz`` (JAX's or the port's): weights replaced,
        optimiser started afresh, step set to the file's. Returns it."""
        from .checkpointing import load_params_npz
        return load_params_npz(self, path)

    def save_checkpoint(self, ckpt_dir: str):
        """Save model, optimiser and step under ``ckpt_dir`` (a second save
        of the same step does nothing)."""
        from .checkpointing import save_trainer_checkpoint
        save_trainer_checkpoint(self, ckpt_dir)

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None):
        from .checkpointing import restore_trainer_checkpoint
        return restore_trainer_checkpoint(self, ckpt_dir, step)

    def fit(self, loader, *args, **kwargs):
        """Training over the streaming loaders is not ported: it needs
        ``NativeWindowedLoader``, ``H5WindowedLoader``, ``ChainLoader`` and
        ``device_prefetch`` (``ROADMAP.md`` queue 1 item 2). Use
        ``train_flow_in_the_loop``."""
        raise ConfigurationError(
            "FlowTrainer.fit needs the streaming loaders, which are not "
            "ported yet (ROADMAP.md queue 1 item 2); train on simulated "
            "scenes with training.train_flow_in_the_loop")
