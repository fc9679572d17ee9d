"""Windowed voxel datasets — the input side of training and serving.

Port of ``event_utils_tpu.data_loaders.base_dataset`` (reference
``lib/data_loaders/base_dataset.py``): a plain-Python sequence protocol
(``__len__`` / ``__getitem__``) that works standalone or under a
``torch.utils.data.DataLoader``.

Windowing methods (reference base_dataset.py:385-417):
- ``k_events``       fixed event count with ``sliding_window_w`` overlap
- ``t_seconds``      fixed duration with ``sliding_window_t`` overlap
- ``between_frames`` all events between consecutive frames
- ``fixed_frames``   ``num_frames`` equal-duration windows

Grids are built on the dataset's ``device`` (the card unless the caller
passes ``device="cpu"``) on one of two routes, and this is the one place
that says which:

- Outside a ``deferred_grids`` scope (training datasets and loaders,
  ``dataset[i]`` alone) one window is voxelized per ``__getitem__`` by
  ``events_to_voxel`` / ``events_to_neg_pos_voxel`` under the package's
  default scatter route (``index_add_`` under ``'xla'``, the CUDA flat
  kernel ``flat_scatter`` under ``ops.set_default_impl('pallas')``): a
  memmap or HDF5 slice, a host-to-device copy, the scatter and, for
  ``return_format="numpy"``, a copy back (``"torch"`` keeps it on the
  device: the JAX package's ``"jax"``).
- Inside one (the serving CLIs' chunk fetch) items record their events
  and the scope's exit builds every grid in one ``get_voxel_grids`` call:
  one upload and, for temporally bilinear grids, the batched voxel kernel
  (``voxel_scatter_batched`` on the card, its plain version on the CPU)
  whatever the default impl, left on the device for the caller to copy
  back in one go.

The two agree within f32 summation order; the default impl does not
govern the second (ROADMAP queue 7 names the fork).

``representation="stacked_histogram"`` builds RVT's stacked histogram in
place of the voxel grid (``representations.histogram``: ``2 num_bins``
polarity-major channels of counts clipped at 10, coordinates divided by
``downsample``), on the same two routes: one window's
``stacked_histogram``, or a scope's windows in one
``stacked_histogram_rows`` call (the flat kernel on the card). It is still
the item's ``"voxel"``, the network's input; ``grid_shape`` gives its
shape.

``collate_padded`` packs ragged per-window events into one fixed-capacity
``(B, capacity, 4)`` array + validity mask (capacity bucketed to powers of
two), the static-shape analogue of the reference's ragged ``collate_fn``
(base_dataset.py:512-539), which is also provided.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device, to_numpy
from ..representations.histogram import (histogram_shape,
                                         stacked_histogram,
                                         stacked_histogram_rows)
from ..representations.voxel_grid import (events_to_neg_pos_voxel,
                                          events_to_voxel,
                                          events_to_voxel_rows)
from .data_augmentation import Compose, build_transform
from ..errors import ConfigurationError, DatasetInitError

RETURN_FORMATS = ("numpy", "torch")
REPRESENTATIONS = ("voxel", "stacked_histogram")

# Each thread's open deferral scopes: dataset id -> its pending items.
_deferrals = threading.local()


def _scopes() -> dict:
    try:
        return _deferrals.scopes
    except AttributeError:
        _deferrals.scopes = {}
        return _deferrals.scopes


def pack_windows(windows) -> np.ndarray:
    """Windows ``(xs, ys, ts, ps)``, none empty, as one ``(4, S, N)``
    float32 block of rows, N the longest window. A shorter row is padded
    with events that weigh nothing and keep its time window: x at -1
    (outside the sensor), the row's last stamp, p 0; so each row's window
    is its own first and last stamp, as one window's is, and no mask is
    needed."""
    S = len(windows)
    N = max(len(w[0]) for w in windows)
    rows = np.empty((4, S, N), np.float32)
    for s, window in enumerate(windows):
        n = len(window[0])
        for c, a in enumerate(window):
            rows[c, s, :n] = a
        rows[:, s, n:] = ((-1.0,), (0.0,), (rows[2, s, n - 1],), (0.0,))
    return rows


class BaseVoxelDataset:
    """Voxel-grid dataset over an event file; grids form on the fly.

    Subclasses implement: ``get_frame(i)``, ``get_flow(i)``,
    ``get_events(idx0, idx1)``, ``load_data(path)`` (filling
    ``sensor_resolution, has_flow, t0, tk, num_events, frame_ts,
    num_frames``), ``find_ts_index(t)`` and ``ts(i)`` — the same contract as
    reference base_dataset.py:65-115.

    ``device`` is where the voxel grids are built: ``None`` means the card
    and raises ``DeviceUnavailableError`` without one; pass ``"cpu"`` for
    the plain scatter on the host. ``representation`` is ``"voxel"`` (the
    temporally bilinear or sliced grid) or ``"stacked_histogram"`` (RVT's,
    with ``downsample``; ``combined_voxel_channels`` and
    ``temporal_bilinear`` are the voxel grid's).
    """

    def get_frame(self, index):
        raise NotImplementedError

    def get_flow(self, index):
        raise NotImplementedError

    def get_events(self, idx0, idx1):
        raise NotImplementedError

    def load_data(self, data_path):
        raise NotImplementedError

    def find_ts_index(self, timestamp):
        raise NotImplementedError

    def ts(self, index):
        raise NotImplementedError

    def close(self):
        """Release any underlying file handles (idempotent).

        HDF5 enforces same-process lock compatibility: a dataset object
        left alive in a reference cycle keeps its read-only handle open
        until GC runs, which makes any later writer open of the same file
        fail nondeterministically. CLIs and tests should close datasets
        when done; ``with`` works too.
        """

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def __init__(self, data_path, transforms=None, sensor_resolution=None,
                 num_bins: int = 5, voxel_method: Optional[Dict] = None,
                 max_length: Optional[int] = None,
                 combined_voxel_channels: bool = False,
                 return_events: bool = False, return_voxelgrid: bool = True,
                 return_frame: bool = True, return_prev_frame: bool = False,
                 return_flow: bool = True, return_prev_flow: bool = False,
                 return_format: str = "numpy",
                 temporal_bilinear: bool = True, device=None,
                 representation: str = "voxel", downsample: int = 1):
        if return_format not in RETURN_FORMATS:
            raise ConfigurationError(
                f"return_format must be one of {RETURN_FORMATS}, got "
                f"{return_format!r}")
        if representation not in REPRESENTATIONS:
            raise ConfigurationError(
                f"representation must be one of {REPRESENTATIONS}, got "
                f"{representation!r}")
        if downsample < 1 or (downsample != 1
                              and representation == "voxel"):
            raise ConfigurationError(
                f"downsample {downsample}: a stacked histogram's divisor of "
                "the coordinates (>= 1); voxel grids take 1")
        self.representation = representation
        self.downsample = int(downsample)
        self.device = resolve_device(device)
        transforms = {} if transforms is None else dict(transforms)
        voxel_method = ({"method": "between_frames"} if voxel_method is None
                        else dict(voxel_method))
        self.num_bins = num_bins
        self.data_path = data_path
        self.combined_voxel_channels = combined_voxel_channels
        self.sensor_resolution = sensor_resolution
        self.data_source_idx = -1
        self.has_flow = False
        self.has_frames = True
        self.return_format = return_format
        self.temporal_bilinear = temporal_bilinear

        self.return_events = return_events
        self.return_voxelgrid = return_voxelgrid
        self.return_frame = return_frame
        self.return_prev_frame = return_prev_frame
        self.return_flow = return_flow
        self.return_prev_flow = return_prev_flow

        self.t0 = self.tk = self.num_events = None
        self.frame_ts = None
        self.num_frames = None

        self.load_data(data_path)

        missing = [n for n in ("sensor_resolution", "t0", "tk", "num_events",
                               "frame_ts", "num_frames")
                   if getattr(self, n) is None]
        if missing or self.has_flow is None:
            raise DatasetInitError(
                f"Dataset failed to initialize members: {missing}")

        self.sensor_resolution = tuple(int(v) for v in self.sensor_resolution[:2])
        self.num_pixels = self.sensor_resolution[0] * self.sensor_resolution[1]
        self.duration = self.tk - self.t0

        self.set_voxel_method(voxel_method)

        # Transform construction via an explicit registry (the reference uses
        # eval(), base_dataset.py:190-195).
        self.normalize_voxels = False
        self.vox_transform = None
        if "RobustNorm" in transforms:
            vox_list = [build_transform(n, **kw) for n, kw in transforms.items()]
            del transforms["RobustNorm"]
            self.normalize_voxels = True
            self.vox_transform = Compose(vox_list)
        t_list = [build_transform(n, **kw) for n, kw in transforms.items()]
        self.transform = (None if not t_list
                          else t_list[0] if len(t_list) == 1
                          else Compose(t_list))
        if not self.normalize_voxels:
            self.vox_transform = self.transform

        if max_length is not None:
            self.length = min(self.length, max_length + 1)

    # ------------------------------------------------------------------
    # Windowing index tables
    # ------------------------------------------------------------------

    def compute_k_indices(self):
        """Fixed-count windows with overlap (reference base_dataset.py:354-367)."""
        k = self.voxel_method["k"]
        stride = k - self.voxel_method["sliding_window_w"]
        return [[i * stride, i * stride + k] for i in range(len(self))]

    def compute_timeblock_indices(self):
        """Fixed-duration windows with overlap (reference base_dataset.py:338-352).

        Divergence (documented): the reference chains ``start_idx =
        previous end_idx``, so with ``sliding_window_t > 0`` its "windows"
        are disjoint ``t - sliding_window_t`` slices, never overlapping —
        a latent defect (SURVEY.md §7.3 class). Here each window's start is
        searched at its own start time, producing true duration-``t``
        overlapping windows — matching the native runtime's
        ``t_second_windows`` (evio.cpp) and the k_events table.
        """
        indices = []
        t = self.voxel_method["t"]
        stride = t - self.voxel_method["sliding_window_t"]
        for i in range(len(self)):
            start_time = stride * i + self.t0
            start_idx = self.find_ts_index(start_time)
            end_idx = self.find_ts_index(start_time + t)
            indices.append([start_idx, end_idx])
        return indices

    def compute_between_frame_indices(self):
        """Frame-synchronized windows (reference base_dataset.py:322-336).

        Divergence (documented): the reference clamps the final end index
        to ``num_events - 1``, permanently dropping the recording's last
        event from the last window (end indices are exclusive); clamping
        to ``num_events`` keeps it.
        """
        indices = []
        start_idx = 0
        for ts in self.frame_ts:
            end_idx = min(self.find_ts_index(ts), self.num_events)
            indices.append([start_idx, end_idx])
            start_idx = end_idx
        return indices

    def compute_per_frame_indices(self):
        """Frames enclosed by each event window (reference base_dataset.py:369-383).

        Divergence (documented): a window that starts at the end of the
        stream (``between_frames`` with a frame stamped after the last
        event) reads the last event's time; the JAX package reads one past
        the end there and raises ``IndexError``.
        """
        frame_indices = []
        frame_ts = np.asarray(self.frame_ts)
        for idx0, idx1 in self.event_indices:
            s_t = self.ts(int(min(idx0, self.num_events - 1)))
            e_t = self.ts(int(min(idx1, self.num_events - 1)))
            i0 = min(int(np.searchsorted(frame_ts, s_t)), len(frame_ts) - 1)
            i1 = min(int(np.searchsorted(frame_ts, e_t)), len(frame_ts) - 1)
            frame_indices.append([-1, -1] if i0 == i1 else [i0, i1])
        return frame_indices

    def set_voxel_method(self, voxel_method):
        """Precompute the event-window index table
        (reference base_dataset.py:385-417)."""
        self.voxel_method = voxel_method
        method = voxel_method["method"]
        if method == "k_events":
            stride = voxel_method["k"] - voxel_method["sliding_window_w"]
            if stride <= 0:
                raise ConfigurationError(
                    f"sliding_window_w ({voxel_method['sliding_window_w']}) "
                    f"must be smaller than k ({voxel_method['k']})")
            self.length = max(int(self.num_events / stride), 0)
            self.event_indices = self.compute_k_indices()
            # guard: final window must not run past the stream
            self.event_indices = [[i0, i1] for i0, i1 in self.event_indices
                                  if i1 <= self.num_events]
            self.length = len(self.event_indices)
        elif method == "t_seconds":
            stride = voxel_method["t"] - voxel_method["sliding_window_t"]
            if stride <= 0:
                raise ConfigurationError(
                    f"sliding_window_t ({voxel_method['sliding_window_t']}) "
                    f"must be smaller than t ({voxel_method['t']})")
            self.length = max(int(self.duration / stride), 0)
            self.event_indices = self.compute_timeblock_indices()
        elif method == "fixed_frames":
            self.length = voxel_method["num_frames"]
            self.voxel_method["t"] = (self.tk - self.t0) / self.length
            self.voxel_method["sliding_window_t"] = 0
            self.event_indices = self.compute_timeblock_indices()
        elif method == "between_frames":
            self.length = self.num_frames - 1
            self.event_indices = self.compute_between_frame_indices()
        else:
            raise ConfigurationError(
                f"Invalid voxel method {voxel_method}")
        if self.has_frames:
            self.frame_indices = self.compute_per_frame_indices()
        if self.length <= 0:
            raise ConfigurationError(
                "Voxel generation parameters give a zero-length sequence")

    def __len__(self):
        return self.length

    def get_event_indices(self, index):
        idx0, idx1 = self.event_indices[index]
        if not (idx0 >= 0 and idx1 <= self.num_events):
            raise IndexError(
                f"Event indices {idx0},{idx1} out of bounds 0,{self.num_events}")
        return int(idx0), int(idx1)

    # ------------------------------------------------------------------
    # Item assembly
    # ------------------------------------------------------------------

    @staticmethod
    def preprocess_events(xs, ys, ts, ps):
        """Empty-window guard: a single zero event
        (reference base_dataset.py:209-224)."""
        if len(xs) == 0:
            z = np.zeros(1)
            return z, z, z, z
        return xs, ys, ts, ps

    def grid_shape(self):
        """``(C, H, W)`` of one window's grid, before any padding: the voxel
        grid's ``num_bins`` (combined) or ``2 num_bins`` channels at the
        sensor's size, or the stacked histogram's ``2 num_bins`` at the
        sensor's size divided by ``downsample``, rounded up."""
        if self.representation == "stacked_histogram":
            return histogram_shape(self.num_bins, self.sensor_resolution,
                                   self.downsample)
        C = self.num_bins if self.combined_voxel_channels \
            else 2 * self.num_bins
        return (C,) + tuple(self.sensor_resolution)

    def _histogram_kw(self):
        return dict(bins=self.num_bins, sensor_size=self.sensor_resolution,
                    downsample=self.downsample)

    def get_voxel_grid(self, xs, ys, ts, ps, combined_voxel_channels=True):
        """On-the-fly voxelization (reference base_dataset.py:433-455):
        ``num_bins x H x W`` combined or ``2*num_bins x H x W`` split, a
        tensor on the dataset's device; the stacked histogram instead
        where the dataset's ``representation`` says so."""
        if self.representation == "stacked_histogram":
            dev = self.device
            return stacked_histogram(
                *(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (xs, ys, ts, ps)), **self._histogram_kw())
        kw = dict(sensor_size=self.sensor_resolution,
                  temporal_bilinear=self.temporal_bilinear,
                  device=self.device)
        if combined_voxel_channels:
            return events_to_voxel(xs, ys, ts, ps, self.num_bins, **kw)
        vp, vn = events_to_neg_pos_voxel(xs, ys, ts, ps, self.num_bins, **kw)
        return torch.cat([vp, vn], 0)

    def get_voxel_grids(self, windows, combined_voxel_channels=True):
        """Grids of several windows in one call: ``(S, C, H, W)`` on the
        dataset's device, grid s what ``get_voxel_grid`` gives on
        ``windows[s]`` (a ``(xs, ys, ts, ps)`` tuple, never empty: see
        ``preprocess_events``) within f32 summation order. The windows go
        up as one ``pack_windows`` block in one copy. Temporally bilinear
        grids take the batched voxel kernel (``impl='matmul'``:
        ``voxel_scatter_batched`` on the card, its plain version on the
        CPU), slice-binned ones and stacked histograms the flat
        scatter."""
        xs, ys, ts, ps = torch.from_numpy(pack_windows(windows)).to(
            self.device)
        if self.representation == "stacked_histogram":
            return stacked_histogram_rows(xs, ys, ts, ps,
                                          **self._histogram_kw())
        return events_to_voxel_rows(
            xs, ys, ts, ps, self.num_bins,
            sensor_size=self.sensor_resolution,
            temporal_bilinear=self.temporal_bilinear,
            split=not combined_voxel_channels,
            impl="matmul" if self.temporal_bilinear else None)

    @contextlib.contextmanager
    def deferred_grids(self):
        """Scope in which ``__getitem__`` builds no voxel grid: each item
        records its events and its transform seed, and leaving the scope
        builds every pending grid in one ``get_voxel_grids`` call, applies
        ``transform_voxel(grid, seed)`` per item as ``__getitem__`` does,
        and fills ``item["voxel"]``. The grids stay on the dataset's
        device, as ``return_format="torch"`` leaves them, whatever
        ``return_format`` says: the caller copies the batch back in one
        go. The scope belongs to the calling thread (threaded loaders call
        ``__getitem__`` concurrently), builds nothing if its block raises,
        and does not nest on one dataset."""
        scopes = _scopes()
        if id(self) in scopes:
            raise RuntimeError("deferred_grids is already open on this "
                               "dataset in this thread")
        pending = scopes[id(self)] = []
        try:
            yield
        finally:
            del scopes[id(self)]
        if pending:
            grids = self.get_voxel_grids(
                [events for _, events, _ in pending],
                combined_voxel_channels=self.combined_voxel_channels)
            for (item, _, seed), grid in zip(pending, grids):
                item["voxel"] = self.transform_voxel(grid, seed)

    # Class-level lock: seeded-transform application draws from the shared
    # module-level `random` (as the JAX package does, so one seed gives the
    # same crop in both), and a threaded loader calls __getitem__ from
    # several threads — without the lock, interleaved seed()/draw()
    # desynchronizes an item's paired voxel/frame/flow crops.
    _transform_lock = threading.Lock()

    def _apply(self, transform, x, seed, is_flow=False):
        if transform is None or x is None:
            return x
        with BaseVoxelDataset._transform_lock:
            random.seed(seed)
            return transform(x, is_flow)

    def transform_frame(self, frame, seed):
        if frame is None:
            return None
        frame = np.asarray(frame, np.float32)[None] / 255.0
        return self._apply(self.transform, frame, seed)

    def transform_voxel(self, voxel, seed):
        return self._apply(self.vox_transform, voxel, seed)

    def transform_flow(self, flow, seed):
        return self._apply(self.transform, flow, seed, is_flow=True)

    def size(self):
        return self.sensor_resolution

    def __getitem__(self, index, seed=None):
        """Item dict (reference base_dataset.py:226-320): voxel grid, raw
        events, frames, flow (converted to pixel displacement by ``* dt``),
        timestamps and index bookkeeping."""
        if index < 0 or index >= len(self):
            raise IndexError
        if seed is None:
            # os.urandom, NOT the module-level random: the seeded-transform
            # lock in _apply only guards transform draws, and an unlocked
            # module-random draw here could interleave with another
            # worker's locked seed/draw sequence and desync paired crops
            import os as _os
            seed = int.from_bytes(_os.urandom(4), "little")

        idx0, idx1 = self.get_event_indices(index)
        xs, ys, ts, ps = self.get_events(idx0, idx1)
        xs, ys, ts, ps = self.preprocess_events(xs, ys, ts, ps)
        ts_0, ts_k = ts[0], ts[-1]
        dt = ts_k - ts_0

        item = {"data_source_idx": self.data_source_idx,
                "data_path": self.data_path, "timestamp": ts_k,
                "dt_between_frames": dt, "ts_idx0": ts_0, "ts_idx1": ts_k,
                "idx0": idx0, "idx1": idx1}

        pending = _scopes().get(id(self))
        if self.return_voxelgrid and pending is not None:
            pending.append((item, (xs, ys, ts, ps), seed))
        elif self.return_voxelgrid:
            voxel = self.get_voxel_grid(
                xs, ys, ts, ps,
                combined_voxel_channels=self.combined_voxel_channels)
            if self.return_format == "numpy":
                voxel = to_numpy(voxel)
            item["voxel"] = self.transform_voxel(voxel, seed)

        if self.voxel_method["method"] == "between_frames":
            frame = self.transform_frame(self.get_frame(index), seed)
            if self.has_flow:
                flow = self.get_flow(index) * dt  # velocity -> displacement
                flow = self.transform_flow(flow, seed)
            else:
                shape = (frame.shape[-2], frame.shape[-1]) if frame is not None \
                    else self.sensor_resolution
                flow = np.zeros((2,) + tuple(shape), np.float32)
            if self.return_flow:
                item["flow"] = flow
                item["flow_ts"] = self.frame_ts[index]
            # Divergence (documented): the reference returns the CURRENT
            # frame/flow for prev_* (base_dataset.py:270-276 calls
            # get_frame(index)/get_flow(index) again), so temporal-pair
            # consumers trained on zero-motion pairs; here prev_* really is
            # index-1 (clamped at the sequence start).
            prev_idx = max(index - 1, 0)
            if self.return_prev_flow:
                if self.has_flow:
                    # velocity -> displacement with the PREVIOUS interval's
                    # duration (the current dt over-/under-scales it
                    # whenever frame spacing varies)
                    pi0, pi1 = self.get_event_indices(prev_idx)
                    dt_prev = (self.ts(max(int(pi1) - 1, int(pi0)))
                               - self.ts(int(pi0))) if pi1 > pi0 else dt
                    item["prev_flow"] = self.transform_flow(
                        self.get_flow(prev_idx) * dt_prev, seed)
                else:
                    item["prev_flow"] = flow
            if self.return_frame:
                item["frame"] = frame
                item["frame_ts"] = self.frame_ts[index]
            if self.return_prev_frame:
                item["prev_frame"] = self.transform_frame(
                    self.get_frame(prev_idx), seed)
        else:
            frames, frame_ts = [], []
            if self.has_frames and self.return_frame:
                fi = self.frame_indices[index]
                if fi[0] != -1:
                    frames = [self.transform_frame(self.get_frame(f), seed)
                              for f in range(fi[0], fi[1])]
                    frame_ts = list(self.frame_ts[fi[0]:fi[1]])
            item["frame"] = frames
            item["frame_ts"] = frame_ts
            flows, flow_ts = [], []
            if self.has_flow and self.return_flow:
                fi = self.frame_indices[index]
                if fi[0] != -1:
                    flows = [self.transform_flow(self.get_flow(f), seed)
                             for f in range(fi[0], fi[1])]
                    flow_ts = list(self.frame_ts[fi[0]:fi[1]])
            item["flow"] = flows
            item["flow_ts"] = flow_ts

        if self.return_events:
            if idx1 - idx0 == 0:
                item["events"] = np.zeros((1, 4), np.float32)
                item["events_batch_indices"] = np.ones((1,))
                item["ts_idx0"] = np.zeros((1,))
            else:
                item["events"] = np.stack(
                    [xs, ys, ts - (ts_0 if self.return_format == "torch" else 0),
                     ps], axis=1).astype(np.float32)
                item["events_batch_indices"] = idx1 - idx0
                item["ts_idx0"] = np.asarray(ts_0)
        return item

    @staticmethod
    def unpackage_events(events):
        """(N, 4) block -> component arrays (reference base_dataset.py:504-510)."""
        return events[:, 0], events[:, 1], events[:, 2], events[:, 3]

    # ------------------------------------------------------------------
    # Collation
    # ------------------------------------------------------------------

    @staticmethod
    def collate_fn(data, event_keys=("events",),
                   idx_keys=("events_batch_indices",)):
        """Ragged collation (reference base_dataset.py:512-539): event blocks
        are concatenated into one ``(N_total, 4)`` array plus per-item end
        indices; everything else is stacked."""
        collated = {}
        events_arr = {k: [] for k in event_keys}
        end_idx = {k: 0 for k in event_keys}
        batch_ends = {k: [] for k in event_keys}
        for item in data:
            for k, v in item.items():
                if k in event_keys:
                    end_idx[k] += v.shape[0]
                    events_arr[k].append(v)
                    batch_ends[k].append(end_idx[k])
                else:
                    collated.setdefault(k, []).append(v)
        out = {}
        for k, vals in collated.items():
            try:
                out[k] = np.stack([np.asarray(v) for v in vals])
            except Exception:
                out[k] = vals
        for ek, ik in zip(event_keys, idx_keys):
            if events_arr[ek]:
                out[ek] = np.concatenate(events_arr[ek], axis=0)
                out[ik] = np.asarray(batch_ends[ek])
        return out

    @staticmethod
    def collate_padded(data, capacity=None, bucket: bool = True):
        """Static-shape collation: events padded to a shared capacity.

        Returns the ``collate_fn`` dict plus ``events`` of shape
        ``(B, capacity, 4)`` and ``events_mask`` of shape ``(B, capacity)``.
        ``capacity`` defaults to the max window length, rounded up to the next
        power of two when ``bucket`` so repeated batches keep a few shapes.
        """
        blocks = [np.asarray(item["events"]) for item in data]
        n_max = max(b.shape[0] for b in blocks)
        if capacity is None:
            capacity = int(2 ** np.ceil(np.log2(max(n_max, 1)))) if bucket else n_max
        B = len(blocks)
        events = np.zeros((B, capacity, 4), np.float32)
        mask = np.zeros((B, capacity), np.float32)
        for i, b in enumerate(blocks):
            n = min(b.shape[0], capacity)
            events[i, :n] = b[:n]
            mask[i, :n] = 1.0
            # padded timestamps replicate the window end (keeps sorts stable)
            if n and n < capacity:
                events[i, n:, 2] = b[n - 1, 2]
        out = {}
        for k in data[0]:
            if k == "events":
                continue
            vals = [item[k] for item in data]
            try:
                out[k] = np.stack([np.asarray(v) for v in vals])
            except Exception:
                out[k] = vals
        out["events"] = events
        out["events_mask"] = mask
        return out
