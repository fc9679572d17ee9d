"""Device placement shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU:

- ``device=None`` means ``"cuda"``; without a card that raises
  ``DeviceUnavailableError`` instead of carrying on quietly on the host;
- tensors that come in keep their device, and numpy or Python inputs of
  the same call follow them there;
- numpy float64 arrays become float32 explicitly (the JAX package computes
  in f32 throughout; ``torch.as_tensor`` would keep the float64).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .errors import DeviceUnavailableError


def resolve_device(device=None) -> torch.device:
    """The device a call runs on when none of its inputs is a tensor."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to use the plain versions")
    return dev


def pick_device(*arrays, device=None) -> torch.device:
    """Device of the first tensor among ``arrays``, else ``device``."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` as a tensor on ``device`` (a tensor keeps its own device).

    ``dtype=None`` keeps integer types and maps every floating type of a
    numpy or Python input to float32.
    """
    if isinstance(a, torch.Tensor):
        return a if dtype is None or a.dtype == dtype else a.to(dtype)
    arr = np.asarray(a)
    if dtype is None and np.issubdtype(arr.dtype, np.floating):
        dtype = torch.float32
    return torch.as_tensor(arr, device=device, dtype=dtype)


def as_f32(a, device: torch.device) -> torch.Tensor:
    return as_tensor(a, device, torch.float32)


def to_numpy(a) -> np.ndarray:
    """Host copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls and convolutions for the duration of the block.

    A float32 convolution goes through cuDNN in TF32 by default, which
    keeps about three decimal digits; the objectives and the BFGS compare
    against an f32 reference. Both flags are restored on exit.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
