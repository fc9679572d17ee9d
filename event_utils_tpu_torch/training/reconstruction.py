"""E2VID training: recurrent voxel-to-intensity supervision (port of
``event_utils_tpu.training.reconstruction``).

E2VID is recurrent, so one training step runs over a ``(T, B, C, H, W)``
voxel sequence with its ConvGRU state threaded through a Python loop over
T (the JAX package's ``lax.scan``) and the loss averaged over the unrolled
windows (truncated BPTT). Supervision is the time-synchronised frames
``(T, B, 1, H, W)``.

- A cold step starts from ``E2VID.zero_state`` and drops the loss of the
  first ``burn_in`` windows; a warm step (``state0`` given: the previous
  segment's ``final_state`` on the same scenes) applies no burn-in. The
  carried state is detached, so BPTT stops at the segment boundary.
- ``ema_decay > 0`` keeps an exponential moving average of the weights,
  updated after every step (``ema = ema * d + (1 - d) * params``);
  ``reconstruct``, ``inference_params`` and the saved ``params.npz`` use
  it, as in JAX.
- Optimiser and schedule as ``training.loop.FlowTrainer``; forward and
  backward run with TF32 off.
- ``model_kwargs["architecture"]`` picks the network
  (``models.networks.RECONSTRUCTION_MODELS``): absent, the port of the
  JAX package's ``E2VID`` (ConvGRU state); ``"UNetRecurrent"``,
  rpg_e2vid's network (one ``(h, c)`` pair of ConvLSTM state a level).
  The key stays in ``model_kwargs``, so saved weights rebuild the same
  network. Only inference (``reconstruct``) is exercised with
  ``UNetRecurrent``.
- ``mesh=``: data-parallel as ``FlowTrainer``. The layout is ``(T, B)``
  with the batch axis sharded: each rank trains on its slice of the B
  sequences, and its recurrent state (``final_state``) is its own batch
  shard. The module is called T times before one backward, which
  ``DistributedDataParallel`` takes (its gradient hooks fire once per
  backward); its mean of the ranks' gradients is the global batch's.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .._device import as_f32, no_tf32, resolve_device
from ..errors import ConfigurationError
from ..models.networks import (RECONSTRUCTION_MODELS, perceptual_filters,
                               reconstruction_loss)
from ..parallel import sharding
from ..utils import profiling
from .loop import AdamStep, Schedule, data_parallel


#: counter of the bytes ``reconstruct`` copies from host arrays to the card
H2D_BYTES = "reconstruct.h2d_bytes"


def _detach(state):
    if isinstance(state, tuple):
        return tuple(_detach(s) for s in state)
    return state.detach()


class ReconstructionTrainer:
    """Supervised E2VID trainer over ``(T, B, C, H, W)`` voxel sequences
    and ``(T, B, 1, H, W)`` target frames on one device, or data-parallel
    over a ``parallel.make_mesh`` mesh (``mesh=``; this rank's device).

    ``model_kwargs`` name the network (``"architecture"``, default
    ``"E2VID"``) and go to it: ``models.networks.E2VID``
    (``recurrent_levels``, ``num_res_blocks``, ``base_features``,
    ``depth``) or ``UNetRecurrent`` (``base_num_channels``,
    ``num_encoders``, ``num_residual_blocks``). They are recorded in saved
    weights (``__model_json__``) and checkpoints (``model.json``).
    ``device``: ``None`` means the card (``DeviceUnavailableError`` without
    one); pass ``"cpu"`` for the host.
    """

    def __init__(self, sensor_size=(64, 64), num_bins: int = 5,
                 combined_channels: bool = False,
                 learning_rate: Schedule = 1e-4, lpips_weight: float = 0.0,
                 seed: int = 0, model_kwargs: Optional[dict] = None,
                 burn_in: int = 0, mse_weight: float = 0.0,
                 ema_decay: float = 0.0, mesh=None, device=None):
        self.mesh = mesh
        self.device = (sharding.mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.sensor_size = tuple(sensor_size)
        self.num_bins = num_bins
        self.combined_channels = combined_channels
        self.model_kwargs = dict(model_kwargs or {})
        self.burn_in = int(burn_in)
        self.lpips_weight = float(lpips_weight)
        self.mse_weight = float(mse_weight)
        self.ema_decay = float(ema_decay)
        channels = num_bins if combined_channels else 2 * num_bins
        kwargs = dict(self.model_kwargs)
        arch = kwargs.pop("architecture", "E2VID")
        if arch not in RECONSTRUCTION_MODELS:
            raise ConfigurationError(
                f"unknown architecture {arch!r}; one of "
                f"{sorted(RECONSTRUCTION_MODELS)}")
        self.model = RECONSTRUCTION_MODELS[arch](
            in_channels=channels, seed=seed,
            **kwargs).to(self.device).eval()
        self.net = data_parallel(self.model, mesh)
        self.opt = AdamStep(self.model.parameters(), learning_rate)
        self.ema_model = None
        self.reset_ema()
        self.filters = (perceptual_filters(device=self.device)
                        if self.lpips_weight else None)
        self.step = 0
        #: final recurrent state of the last train step (detached) — pass it
        #: back as ``state0`` to continue the same scenes
        self.final_state = None

    @property
    def optimizer(self) -> torch.optim.Adam:
        return self.opt.optimizer

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return sharding.is_writer(self.mesh)

    def shard(self, seq):
        """This rank's slice of the batch axis (1) of a ``(T, B, ...)``
        sequence (all of it without a mesh)."""
        return seq[:, sharding.shard_slice(self.mesh, seq.shape[1])]

    def reset_ema(self):
        """Restart the EMA from the current weights (when enabled)."""
        if self.ema_decay:
            self.ema_model = copy.deepcopy(self.model)
            for p in self.ema_model.parameters():
                p.requires_grad_(False)

    @property
    def inference_model(self) -> torch.nn.Module:
        """The EMA model when enabled, else the trained one."""
        return self.ema_model if self.ema_model is not None else self.model

    @property
    def inference_params(self):
        """The deliverable weights (a state dict): the EMA when enabled."""
        return self.inference_model.state_dict()

    def sequence_loss(self, voxels, frames, state0=None, burn_in: int = 0):
        """Mean loss over the unrolled windows past ``burn_in`` and the
        final state (differentiable; no step)."""
        T = voxels.shape[0]
        if burn_in and burn_in >= T:
            raise ConfigurationError(
                f"burn_in={burn_in} must be < seq_len={T} (no supervised "
                "windows left)")
        state = state0
        if state is None:
            state = self.model.zero_state(voxels.shape[1], voxels.shape[-2],
                                          voxels.shape[-1], voxels.device)
        losses = []
        for vox, frame in zip(voxels, frames):
            pred, state = self.net(vox, state)
            losses.append(reconstruction_loss(
                pred, frame, lpips_weight=self.lpips_weight,
                mse_weight=self.mse_weight, filters=self.filters))
        return torch.stack(losses)[burn_in:].mean(), state

    def train_sequence_async(self, voxels, frames, state0=None,
                             sharded: bool = False):
        """One truncated-BPTT step; returns the loss as a 0-d tensor on the
        device without waiting for it.

        ``state0``: the previous segment's ``final_state`` when ``voxels``
        continues the same scenes (no burn-in then); default zero state
        with the configured ``burn_in``. ``final_state`` is refreshed.
        Under a mesh ``voxels`` and ``frames`` are the global batch (or,
        with ``sharded=True``, this rank's slice of it), ``state0`` and
        ``final_state`` this rank's shard, and the loss the global one."""
        if not sharded:
            voxels, frames = self.shard(voxels), self.shard(frames)
        dev = self.device
        voxels = as_f32(voxels, dev)
        frames = as_f32(frames, dev)
        warm = state0 is not None
        with no_tf32():
            loss, state = self.sequence_loss(
                voxels, frames, _detach(state0) if warm else None,
                0 if warm else self.burn_in)
            self.opt.minimize(loss)
        if self.ema_model is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema_model.parameters(),
                                self.model.parameters()):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self.final_state = _detach(state)
        self.step += 1
        return sharding.all_reduce(loss.detach().clone(), self.mesh, "mean")

    def train_sequence(self, voxels, frames, state0=None) -> float:
        """Synchronous ``train_sequence_async`` (returns a float)."""
        return float(self.train_sequence_async(voxels, frames, state0))

    @torch.no_grad()
    def reconstruct(self, voxels, state=None):
        """Run over a ``(T, B, C, H, W)`` sequence; returns ``(images (T, B,
        1, H, W), final_state)``, with the EMA weights when enabled.
        ``state=None`` starts from the all-zero state; the state is the
        network's own (``E2VID``: tensors; ``UNetRecurrent``: ``(h, c)``
        pairs). Spans ``e2vid.forward`` (each window's forward pass);
        counters ``e2vid.windows`` (windows through the network) and
        ``reconstruct.h2d_bytes`` (a host ``voxels`` copied to the card)."""
        model = self.inference_model
        upload = (not isinstance(voxels, torch.Tensor)
                  and self.device.type != "cpu")
        voxels = as_f32(voxels, self.device)
        if upload:
            profiling.count(H2D_BYTES,
                            voxels.numel() * voxels.element_size())
        if state is None:
            state = model.zero_state(voxels.shape[1], voxels.shape[-2],
                                     voxels.shape[-1], self.device)
        preds = []
        for vox in voxels:
            with profiling.span("e2vid.forward"):
                pred, state = model(vox, state)
            profiling.count("e2vid.windows", vox.shape[0])
            preds.append(pred)
        return torch.stack(preds), state

    # ------------------------------------------------------------------
    def load_params(self, path: str) -> int:
        """Load a ``params.npz`` (JAX's or the port's): weights replaced,
        optimiser started afresh, the EMA re-seeded from the weights, step
        set to the file's. Returns it."""
        from .checkpointing import load_params_npz
        return load_params_npz(self, path)

    def save_checkpoint(self, ckpt_dir: str):
        from .checkpointing import save_trainer_checkpoint
        if self.is_writer:
            save_trainer_checkpoint(self, ckpt_dir)

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None):
        from .checkpointing import restore_trainer_checkpoint
        return restore_trainer_checkpoint(self, ckpt_dir, step)
