"""EV-FlowNet inference: the ``predict`` half of the JAX package's
``training.loop.FlowTrainer``.

The self-supervised train step (``contrast_flow_loss``, the optimiser, the
mesh and checkpoint saving) belongs to the training slice and is not
ported yet.
"""

from __future__ import annotations

import torch

from .._device import as_f32, resolve_device
from ..convert import load_params_npz
from ..models.networks import EVFlowNet


class FlowTrainer:
    """EV-FlowNet over ``(B, C, H, W)`` voxel batches on one device.

    @param sensor_size (H, W) — divisible by 2^depth (pad with
        ``utils.util.CropParameters`` otherwise)
    @param seed Seed of the random initial weights (``load_params`` replaces
        them)
    @param device Where the model runs: ``None`` means the card and raises
        ``DeviceUnavailableError`` without one; pass ``"cpu"`` for the host.
    """

    def __init__(self, sensor_size=(64, 64), num_bins: int = 5,
                 combined_channels: bool = False, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.sensor_size = tuple(sensor_size)
        self.num_bins = num_bins
        self.combined_channels = combined_channels
        self.model_kwargs = {}
        channels = num_bins if combined_channels else 2 * num_bins
        self.model = EVFlowNet(in_channels=channels, seed=seed).to(
            self.device).eval()
        self.step = 0

    def load_params(self, path: str) -> int:
        """Load a JAX ``params.npz`` (``convert.load_params_npz``); returns
        and records its step."""
        self.step = load_params_npz(self.model, path, self.model_kwargs)
        return self.step

    @torch.no_grad()
    def predict(self, voxel) -> torch.Tensor:
        """``(B, 2, H, W)`` flow in px/s, on the trainer's device."""
        return self.model(as_f32(voxel, self.device))
