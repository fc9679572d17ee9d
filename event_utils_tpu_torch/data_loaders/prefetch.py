"""Threaded batching and pinned-memory host-to-device prefetch (port of
``event_utils_tpu.data_loaders.prefetch``).

``EventDataLoader`` assembles batches of any sequence-protocol dataset,
optionally on background threads. ``device_prefetch`` keeps
``prefetch_depth`` batches in flight to the card: each numeric array of a
batch is staged into a pinned host buffer at once (so the loader may reuse
its own buffer), copied on a dedicated CUDA stream, and handed out only
after the consumer's stream has been made to wait for that copy. JAX's
``jax.device_put`` does the same job in the reference.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device


class EventDataLoader:
    """Iterate a sequence-protocol dataset in (optionally shuffled) batches.

    @param dataset Any object with ``__len__`` / ``__getitem__`` returning
        item dicts (e.g. ``DynamicH5Dataset``).
    @param batch_size Items per batch.
    @param shuffle Shuffle item order each epoch (seeded via ``rng``).
    @param collate_fn Batch assembly; defaults to the dataset's
        ``collate_padded`` when present (static shapes) else ``collate_fn``.
    @param num_workers 0 = synchronous; 1 = one background producer thread;
        >1 = producer plus a pool of that many item-fetch threads
        (h5py and np.load release the GIL, so fetches overlap).
    @param drop_last Drop the final partial batch.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 drop_last: bool = False,
                 rng: Optional[np.random.Generator] = None,
                 queue_depth: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = rng or np.random.default_rng()
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        if collate_fn is None:
            collate_fn = getattr(type(dataset), "collate_padded", None)
            # collate_padded packs item["events"]: a dataset made without
            # return_events has no such key
            if collate_fn is not None and not getattr(dataset,
                                                      "return_events", True):
                collate_fn = None
            if collate_fn is None:
                collate_fn = getattr(type(dataset), "collate_fn",
                                     _default_collate)
        self.collate_fn = collate_fn

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            for idx in self._batches():
                yield self.collate_fn([self.dataset[i] for i in idx])
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        """Background batch assembly: item fetches fan out over
        ``num_workers`` threads, producer errors are raised in the consumer,
        and abandoning the iterator stops the producer (a timeout-checked
        event, not a put that blocks forever)."""
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()
        pool = (ThreadPoolExecutor(self.num_workers)
                if self.num_workers > 1 else None)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def fetch(idx):
            if pool is not None:
                return list(pool.map(self.dataset.__getitem__, idx))
            return [self.dataset[i] for i in idx]

        def producer():
            try:
                for idx in self._batches():
                    if stop.is_set():
                        return
                    if not put(("ok", self.collate_fn(fetch(idx)))):
                        return
                put(("done", None))
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                put(("err", exc))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "err":
                    raise item
                if kind == "done":
                    break
                yield item
        finally:
            stop.set()  # break/close/GC: release a blocked producer
            t.join()
            if pool is not None:
                pool.shutdown(wait=False)


def _default_collate(items):
    """Stack each key: tensors with ``torch.stack``, anything else with
    ``np.stack``; a key that does not stack stays a list."""
    out = {}
    for k in items[0]:
        vals = [item[k] for item in items]
        try:
            if all(isinstance(v, torch.Tensor) for v in vals):
                out[k] = torch.stack(vals)
            else:
                out[k] = np.stack([np.asarray(v) for v in vals])
        except (RuntimeError, ValueError, TypeError):
            out[k] = vals
    return out


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _moved(k, v, keys) -> bool:
    return ((keys is None or k in keys) and isinstance(v, np.ndarray)
            and np.issubdtype(v.dtype, np.number))


class PinnedRing:
    """Pinned host buffers for one batch key, reused round-robin.

    A buffer is handed out again only after the CUDA event of the copy
    that last read it has completed (``acquire`` waits for it), so a
    refill can never race an upload still in flight, whatever the depth.
    """

    def __init__(self, depth: int):
        self.slots = [None] * depth  # [host tensor, event of its last copy]
        self.next = 0

    def acquire(self, shape, dtype: torch.dtype) -> list:
        i = self.next
        self.next = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None and slot[1] is not None:
            slot[1].synchronize()
        if slot is None or slot[0].shape != tuple(shape) or \
                slot[0].dtype != dtype:
            slot = [torch.empty(tuple(shape), dtype=dtype, pin_memory=True),
                    None]
            self.slots[i] = slot
        return slot


def device_prefetch(iterator, prefetch_depth: int = 2, device=None,
                    keys=None):
    """Keep ``prefetch_depth`` batches in flight to ``device`` ahead of use.

    Numeric numpy entries of each batch dict (only those in ``keys`` when
    given) become tensors on ``device``; everything else passes through.
    ``device=None`` means the card (``DeviceUnavailableError`` without
    one). On a CUDA device each array is copied into a pinned buffer of
    its key's ring at once, uploaded with ``copy_(non_blocking=True)`` on a
    dedicated copy stream, and an event is recorded; before the batch is
    yielded the consumer's current stream waits on that event and each
    tensor is ``record_stream``-ed on it, so the copy of batch k+1 overlaps
    the compute of batch k. On the CPU the arrays are copied into tensors
    (the native loaders reuse their buffers).
    """
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        def to_host(batch):
            return {k: torch.tensor(v) if _moved(k, v, keys) else v
                    for k, v in batch.items()}
        for batch in it:
            yield to_host(batch)
        return

    copy_stream = torch.cuda.Stream(dev)
    rings: dict = {}

    def to_device(batch):
        out, staged = {}, []
        for k, v in batch.items():
            if not _moved(k, v, keys):
                out[k] = v
                continue
            ring = rings.setdefault(k, PinnedRing(prefetch_depth + 1))
            slot = ring.acquire(v.shape, _torch_dtype(v.dtype))
            # the loader's buffer is free from here on
            np.copyto(slot[0].numpy(), v)
            with torch.cuda.stream(copy_stream):
                out[k] = torch.empty_like(slot[0], device=dev)
                out[k].copy_(slot[0], non_blocking=True)
            staged.append((k, slot))
        done = torch.cuda.Event()
        done.record(copy_stream)
        for _, slot in staged:
            slot[1] = done
        return out, done, [k for k, _ in staged]

    def hand_out(entry):
        out, done, moved = entry
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(done)
        for k in moved:
            out[k].record_stream(stream)
        return out

    buf = collections.deque()
    for batch in it:
        buf.append(to_device(batch))
        if len(buf) >= max(prefetch_depth, 1):
            break
    while buf:
        nxt = buf.popleft()
        for batch in it:
            buf.append(to_device(batch))
            break
        yield hand_out(nxt)
