"""Time ordering of event streams (port of ``event_utils_tpu.ops.sort``).

A densified stream is *k-sorted*: every synthetic event is a bounded time
jitter away from a sorted source event, so every element sits within a
computable rank distance ``D`` of its final place (:func:`displacement_bound`).
The JAX package sorts such a stream with two passes of disjoint block sorts,
because a TPU's global sort is slow.

Here every sort is one ``torch.sort(stable=True)`` on the keys (a library
sort: JAX's ``lax.sort`` is no Pallas kernel either) followed by one gather
per payload. On an H100 the global sort of a densified 2^21-slot stream is
faster than the two row passes (``chip_smoke.py``'s augmentation phase,
PERF.md), and being stable it gives the permutation that JAX's row passes
give whenever their bound holds, and that its fallback gives otherwise. So
:func:`nearly_sorted_sort` and :func:`nearly_sorted_argsort` take JAX's
``block`` argument and sort globally; :func:`displacement_bound` and
:func:`sort_block_for` keep JAX's analysis for callers that read it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["nearly_sorted_argsort", "nearly_sorted_sort", "time_sort",
           "displacement_bound", "sort_block_for", "MAX_SORT_BLOCK"]

# JAX's largest row-pass block: sort_block_for returns None (the global
# sort) above it.
MAX_SORT_BLOCK = 1 << 14


def time_sort(keys, *payloads):
    """Stable global sort of ``keys`` carrying ``payloads``.

    Returns ``(sorted_keys, *permuted_payloads)``.
    """
    k, order = torch.sort(torch.as_tensor(keys), stable=True)
    return (k,) + tuple(torch.as_tensor(p, device=k.device)[order]
                        for p in payloads)


def nearly_sorted_sort(keys, *payloads, block: int):
    """Stable sort of a k-sorted ``keys`` carrying ``payloads``: JAX's
    signature, :func:`time_sort`'s answer (``block`` is not used, see the
    module docstring). Returns ``(sorted_keys, *permuted_payloads)``."""
    return time_sort(keys, *payloads)


def nearly_sorted_argsort(keys, block: int) -> torch.Tensor:
    """Stable argsort of ``keys``: ``order`` such that ``keys[order]`` is
    non-decreasing with ties in source order (``block`` is not used, see
    the module docstring). int64, PyTorch's index type (JAX returns
    int32)."""
    return torch.sort(torch.as_tensor(keys), stable=True).indices


def displacement_bound(ts_sorted, delta, copies: int = 2) -> torch.Tensor:
    """Max rank displacement of a stream built from ``copies`` interleaved
    per-event copies of the sorted ``ts_sorted``, each perturbed by at most
    ``delta`` in time.

    Elements ``j < k`` of such a stream can invert only if their
    unperturbed times are within ``2 * delta``, so the displacement is
    bounded by the densest ``+-2 delta`` time window, times ``copies``.
    ``delta`` may be a number or a scalar tensor on the keys' device.
    Returns an int32 scalar tensor on the keys' device.

    Non-finite entries (``+inf`` pad-slot keys) are left out of the max:
    tail pads are already in their final places. The finite prefix must
    still be sorted.
    """
    ts_sorted = torch.as_tensor(ts_sorted).contiguous()
    w = 2.0 * torch.as_tensor(delta, dtype=ts_sorted.dtype,
                              device=ts_sorted.device)
    hi = torch.searchsorted(ts_sorted, ts_sorted + w, side="right")
    lo = torch.searchsorted(ts_sorted, ts_sorted - w, side="left")
    span = torch.where(torch.isfinite(ts_sorted), hi - lo, 0)
    return (span.max() * copies).to(torch.int32)


def sort_block_for(ts_sorted, delta, copies: int = 2,
                   max_block: int = MAX_SORT_BLOCK) -> Optional[int]:
    """JAX's block for its row passes over a stream of ``copies``
    interleaved jittered copies of ``ts_sorted`` (one host read): the power
    of two at least twice :func:`displacement_bound`, or ``None`` above
    ``max_block``."""
    d = int(displacement_bound(ts_sorted, delta, copies))
    block = 1 << int(np.ceil(np.log2(max(2 * d, 2))))
    return block if block <= max_block else None
