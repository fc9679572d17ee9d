"""Batched-event unpacking helpers (port of
``event_utils_tpu.data_loaders.dataloader_util``, a copy; reference
lib/data_loaders/dataloader_util.py, with its undefined-name bugs
fixed — the reference references ``event_batch_indices``/``start_dx`` that
don't exist, dataloader_util.py:23-24)."""

from __future__ import annotations

import numpy as np


def unpack_batched_events(events, batch_indices):
    """Split one contiguous ``(N_total, 4)`` event block back into a padded
    ``(B, M, 4)`` batch, where ``M`` is the largest per-item count.

    @param events Contiguous events from ``collate_fn``
    @param batch_indices Per-item *end* indices into ``events``
    @returns ``(B, M, 4)`` zero-padded array and ``(B, M)`` validity mask
    """
    events = np.asarray(events)
    ends = list(np.asarray(batch_indices).ravel())
    starts = [0] + ends[:-1]
    maxlen = max(e - s for s, e in zip(starts, ends))
    B = len(ends)
    out = np.zeros((B, maxlen, events.shape[1]), events.dtype)
    mask = np.zeros((B, maxlen), np.float32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        out[i, :e - s] = events[s:e]
        mask[i, :e - s] = 1.0
    return out, mask
