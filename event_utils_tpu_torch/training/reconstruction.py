"""E2VID inference: the ``reconstruct`` half of the JAX package's
``training.reconstruction.ReconstructionTrainer``.

The recurrent model runs over ``(T, B, C, H, W)`` voxel sequences with its
ConvGRU state threaded through a Python loop over T (the JAX package's
``lax.scan``). Training (truncated BPTT, the loss, the EMA, checkpoint
saving) belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import as_f32, resolve_device
from ..convert import load_params_npz
from ..models.networks import E2VID


class ReconstructionTrainer:
    """E2VID over ``(T, B, C, H, W)`` voxel sequences on one device.

    ``model_kwargs`` go to ``models.networks.E2VID`` (``recurrent_levels``,
    ``num_res_blocks``, ``base_features``, ``depth``) and must equal the
    ``__model_json__`` of any ``params.npz`` loaded into it.
    ``device``: ``None`` means the card (``DeviceUnavailableError`` without
    one); pass ``"cpu"`` for the host.
    """

    def __init__(self, sensor_size=(64, 64), num_bins: int = 5,
                 combined_channels: bool = False, seed: int = 0,
                 model_kwargs: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.sensor_size = tuple(sensor_size)
        self.num_bins = num_bins
        self.combined_channels = combined_channels
        self.model_kwargs = dict(model_kwargs or {})
        channels = num_bins if combined_channels else 2 * num_bins
        self.model = E2VID(in_channels=channels, seed=seed,
                           **self.model_kwargs).to(self.device).eval()
        self.step = 0

    def load_params(self, path: str) -> int:
        """Load a JAX ``params.npz`` (``convert.load_params_npz``); returns
        and records its step."""
        self.step = load_params_npz(self.model, path, self.model_kwargs)
        return self.step

    @property
    def inference_params(self):
        """The weights ``reconstruct`` uses, as a state dict (the JAX
        trainer's EMA belongs to training, which is not ported)."""
        return self.model.state_dict()

    @torch.no_grad()
    def reconstruct(self, voxels, state=None):
        """Run over a ``(T, B, C, H, W)`` sequence; returns ``(images (T, B,
        1, H, W), final_state)``. ``state=None`` starts from the all-zero
        state of the model's own shapes (``E2VID.zero_state``)."""
        voxels = as_f32(voxels, self.device)
        if state is None:
            state = self.model.zero_state(voxels.shape[1], voxels.shape[-2],
                                          voxels.shape[-1], self.device)
        preds = []
        for vox in voxels:
            pred, state = self.model(vox, state)
            preds.append(pred)
        return torch.stack(preds), state
