"""Full-frame bilinear scatter with the signature of the JAX package's
one-hot-matmul path (port of ``event_utils_tpu.ops.matmul_scatter``).

JAX factorises the 4-tap splat of a chunk of events into one matmul of
one-hot factor matrices, because a TPU has no fast scatter. The card has
one: here the function is the port's bilinear kernel
(``ops.cuda_scatter.bilinear_matmul``, which replaces the TPU's
``_bilinear_kernel``) on CUDA tensors, and its plain version on CPU
tensors. ``chunk`` has no counterpart (no chunked scan is needed) and is
accepted for the signature. ``precision`` ('bf16', 'hilo') is accepted
and computed in f32, which lies inside both classes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import as_f32, pick_device
from ..errors import ConfigurationError
from .cuda_scatter import bilinear_matmul

DEFAULT_CHUNK = 8192
PRECISIONS = ("bf16", "hilo")


def bilinear_scatter_matmul(x, y, w, shape: Tuple[int, int],
                            mask: Optional[torch.Tensor] = None,
                            chunk: int = DEFAULT_CHUNK,
                            precision: str = "bf16",
                            device=None) -> torch.Tensor:
    """4-tap bilinear scatter-add: taps outside ``shape`` are dropped.

    ``w`` may be ``(N,)`` -> ``(H, W)`` output, or ``(K, N)`` -> ``(K, H,
    W)``: K weight channels at the same coordinates. ``mask`` multiplies
    the weights. Differentiable in ``x``, ``y`` and ``w``.
    """
    if precision not in PRECISIONS:
        raise ConfigurationError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")
    dev = pick_device(x, y, w, mask, device=device)
    x, y, w = as_f32(x, dev), as_f32(y, dev), as_f32(w, dev)
    if mask is not None:
        mask = as_f32(mask, dev)
    return bilinear_matmul(x, y, w, shape, mask=mask)
