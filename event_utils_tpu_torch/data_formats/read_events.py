"""Event-file readers: Monash-style HDF5 and RPG-style memmap directories.

Port of ``event_utils_tpu.data_formats.read_events`` (a copy: the module is
host-side numpy; ``h5py`` is imported only by the HDF5 readers). Outputs
are numpy arrays; the datasets move them to the device.

File layouts supported (identical to the reference):

- HDF5: ``events/{xs,ys,ts,ps}`` (+ legacy ``events/{x,y,ts,p}``), frames as
  ``images/image{:09d}`` datasets with ``timestamp``/``event_idx`` attrs.
  Polarity on disk is {0, 1}; mapped to {-1, +1} on read
  (reference read_events.py:120, 134).
- memmap dir: ``t.npy, xy.npy, p.npy`` (+ ``images.npy, timestamps.npy,
  optic_flow.npy, optic_flow_timestamps.npy, index.npy``), opened with
  ``mmap_mode='r'`` so nothing loads until sliced.
"""

from __future__ import annotations

import os

import numpy as np
from ..errors import DataFormatError, DataNotFoundError


def compute_indices(event_stamps, frame_stamps):
    """Reference-parity event index table (reference read_events.py:5-17).

    Reference quirk kept: the returned ``(F-1, 2)`` rows are
    ``(end_i, start_i)`` — column 0 is the searchsorted of frame i+1's
    stamp (the interval END), column 1 of frame i's (the START) — despite
    the reference docstring claiming "beginning and end". Use
    :func:`frame_event_indices` for the sane ``(start, end)`` layout this
    framework's writers emit."""
    event_stamps = np.asarray(event_stamps)
    if event_stamps.ndim > 1:
        event_stamps = event_stamps[:, 0]
    frame_stamps = np.asarray(frame_stamps)
    indices_first = np.searchsorted(event_stamps, frame_stamps[1:])
    indices_last = np.searchsorted(event_stamps, frame_stamps[:-1])
    return np.stack([indices_first, indices_last], -1)


def frame_event_indices(event_stamps, frame_stamps):
    """Canonical ``(F, 2)`` int64 index table: row i is the ``(start, end)``
    (end exclusive) range of events up to and including frame i's timestamp,
    with ``start_i = end_{i-1}`` and ``end_i = searchsorted(ts, frame_ts[i],
    'right')-ish via searchsorted left — exactly the ``between_frames``
    windowing convention of the dataset layer. This is the layout BOTH
    framework writers (``memmap_packager``, ``h5_to_memmap``) store in
    ``index.npy``."""
    event_stamps = np.asarray(event_stamps)
    if event_stamps.ndim > 1:
        event_stamps = event_stamps[:, 0]
    ends = np.searchsorted(event_stamps, np.asarray(frame_stamps))
    starts = np.concatenate([[0], ends[:-1]])
    return np.stack([starts, ends], axis=-1).astype(np.int64)


def _normalize_frame_index(raw, num_events, num_frames=None, layout=None):
    """Best-effort normalisation of an ``index.npy`` into the canonical
    ``(F, 2) (start, end)`` "events up to frame i" layout: handles this
    framework's canonical tables, reference ``compute_indices`` output
    (``(F-1, 2)`` reversed-column rows covering ``[frame_i, frame_{i+1})``
    — realigned AND re-rowed, not just swapped), and reference
    ``h5_to_memmap`` attr dumps (``(F, 1)``/``(F,)`` end indices).

    ``layout='start_end_v1'`` (the ``index_layout`` marker this framework's
    writers put in ``metadata.json``) asserts the canonical layout and skips
    the heuristics. Without the marker the heuristic CANNOT distinguish a
    canonical table from any other all-``start<=end`` convention (e.g. rows
    meaning "events AFTER frame i"); directories written by pre-marker
    builds with a foreign convention must be re-converted."""
    raw = np.asarray(raw).astype(np.int64)
    if layout == "start_end_v1":
        if raw.ndim == 2 and raw.shape[1] == 2 and np.all(
                raw[:, 0] <= raw[:, 1]):
            return raw
        # e.g. an index.npy regenerated by a foreign tool next to this
        # framework's metadata.json: surface the mix-up, don't guess
        raise DataFormatError(
            "index.npy marked start_end_v1 but violates the layout "
            f"(shape {raw.shape}); re-run the converter to regenerate it")
    if raw.ndim == 1 or (raw.ndim == 2 and raw.shape[1] == 1):
        ends = raw.reshape(-1)
        starts = np.concatenate([[0], ends[:-1]])
        return np.stack([starts, ends], axis=-1)
    if raw.ndim == 2 and raw.shape[1] == 2:
        if np.all(raw[:, 0] <= raw[:, 1]):
            return raw  # already (start, end)
        if np.all(raw[:, 1] <= raw[:, 0]):
            # Reference compute_indices: row i is (idx(frame_{i+1}),
            # idx(frame_i)) — the events AFTER frame i, one row per frame
            # interval (F-1 rows). Canonical row i is the events UP TO
            # frame i (F rows): prepend [0, idx(frame_0)] and shift.
            if num_frames is not None and raw.shape[0] == num_frames - 1:
                ends = np.concatenate([[raw[0, 1]], raw[:, 0]])
                starts = np.concatenate([[0], ends[:-1]])
                return np.stack([starts, ends], axis=-1)
            return raw[:, ::-1]  # frame count unknown: column swap only
    return raw  # unknown layout: hand back as loaded


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

def _h5_event_datasets(f):
    """Return the four event datasets, handling the legacy naming."""
    if "events/x" in f:  # legacy layout
        return f["events/x"], f["events/y"], f["events/ts"], f["events/p"]
    return f["events/xs"], f["events/ys"], f["events/ts"], f["events/ps"]


def read_h5_event_components(hdf_path):
    """Events as four numpy arrays ``(xs, ys, ts, ps)`` with polarity in
    {-1, +1} (reference read_events.py:125-136)."""
    import h5py
    with h5py.File(hdf_path, "r") as f:
        dx, dy, dt, dp = _h5_event_datasets(f)
        return (dx[:], dy[:], dt[:], np.where(dp[:], 1, -1))


def read_h5_events(hdf_path):
    """Events as an ``(N, 4)`` block (reference read_events.py:111-123)."""
    xs, ys, ts, ps = read_h5_event_components(hdf_path)
    return np.stack([xs, ys, ts, ps], axis=1)


def read_h5_events_dict(hdf_path, read_frames: bool = True):
    """Events (+frames) as a dict (reference read_events.py:138-176):
    keys ``xs, ys, ts, ps`` and, when frames exist,
    ``frames, frame_timestamps, frame_event_indices``."""
    import h5py
    with h5py.File(hdf_path, "r") as f:
        dx, dy, dt, dp = _h5_event_datasets(f)
        events = {"xs": dx[:], "ys": dy[:], "ts": dt[:],
                  "ps": np.where(dp[:], 1, -1)}
        if read_frames and "images" in f:
            frames, stamps, eidx = [], [], []
            for key in sorted(f["images"]):
                dset = f[f"images/{key}"]
                frames.append(dset[:])
                stamps.append(dset.attrs.get("timestamp", 0.0))
                eidx.append(dset.attrs.get("event_idx", 0))
            events["frames"] = frames
            events["frame_timestamps"] = np.asarray(stamps)
            events["frame_event_indices"] = np.asarray(eidx)
    return events


# ---------------------------------------------------------------------------
# memmap
# ---------------------------------------------------------------------------

def read_memmap_events(memmap_path, skip_frames: int = 1,
                       return_events: bool = False,
                       images_file="images.npy",
                       images_ts_file="timestamps.npy",
                       optic_flow_file="optic_flow.npy",
                       optic_flow_ts_file="optic_flow_timestamps.npy",
                       events_xy_file="xy.npy", events_p_file="p.npy",
                       events_t_file="t.npy"):
    """Open an RPG-style memmap directory (reference read_events.py:19-93).

    Returns a dict with memmap handles (or materialized arrays when
    ``return_events``): keys ``index, frame_stamps, images, optic_flow,
    optic_flow_stamps, t, xy, p, t0, num_events, path``.
    """
    if not os.path.isdir(memmap_path):
        raise NotADirectoryError(f"{memmap_path} is not a memmap directory")

    # Reference-style roots may nest the component files one level down
    # (reference read_events.py:55 walks subroots; MemMapDataset does too):
    # descend to the first directory that holds the timestamp file.
    root = memmap_path
    if not os.path.exists(os.path.join(root, events_t_file)):
        for sub, _dirs, files in sorted(os.walk(memmap_path)):
            if events_t_file in files:
                root = sub
                break

    data = {}
    for fname in sorted(os.listdir(root)):
        path = os.path.join(root, fname)
        if not fname.endswith(".npy"):
            continue
        if fname == "index.npy":
            data["index_raw"] = np.load(path).astype("int64")
        elif fname == images_ts_file:
            data["frame_stamps"] = np.load(path)[::skip_frames, ...]
        elif fname == images_file:
            data["images"] = np.load(path, mmap_mode="r")[::skip_frames, ...]
        elif fname == optic_flow_file:
            data["optic_flow"] = np.load(path, mmap_mode="r")[::skip_frames, ...]
        elif fname == optic_flow_ts_file:
            data["optic_flow_stamps"] = np.load(path)[::skip_frames, ...]
        elif fname == events_t_file:
            handle = np.load(path, mmap_mode="r")
            data["t"] = handle[:].squeeze() if return_events else handle
            data["t0"] = (float(np.asarray(handle[0]).squeeze())
                          if len(handle) else 0.0)
        elif fname == events_xy_file:
            handle = np.load(path, mmap_mode="r")
            data["xy"] = handle[:].squeeze() if return_events else handle
        elif fname == events_p_file:
            handle = np.load(path, mmap_mode="r")
            data["p"] = handle[:].squeeze() if return_events else handle

    missing = [n for n, k in ((events_t_file, "t"), (events_xy_file, "xy"),
                              (events_p_file, "p")) if k not in data]
    if missing:
        raise DataNotFoundError(
            f"No event data found in {memmap_path} (missing "
            f"{', '.join(missing)})")
    if not (len(data["p"]) == len(data["xy"]) == len(data["t"])):
        raise DataFormatError(
            f"Inconsistent event component lengths in {memmap_path}")
    data["path"] = memmap_path
    data["num_events"] = len(data["p"])
    # "index" is ALWAYS the canonical (F, 2) (start, end) table (see
    # frame_event_indices); foreign layouts (reference compute_indices /
    # attr dumps) are normalized, the as-loaded table stays in "index_raw".
    if "index_raw" in data:
        num_frames = (len(np.load(os.path.join(root, images_ts_file)))
                      if os.path.exists(os.path.join(root, images_ts_file))
                      else None)
        layout = None
        meta_path = os.path.join(root, "metadata.json")
        if os.path.exists(meta_path):
            import json
            try:
                with open(meta_path) as mf:
                    layout = json.load(mf).get("index_layout")
            except (OSError, ValueError):
                layout = None
        idx = _normalize_frame_index(data["index_raw"], data["num_events"],
                                     num_frames=num_frames, layout=layout)
        if skip_frames > 1 and idx.ndim == 2 and idx.shape[1] == 2:
            # Frames were strided; merge the skipped windows so row j still
            # ends at retained frame j and starts at the previous retained
            # frame's end (canonical contract under subsampling).
            ends = idx[::skip_frames, 1]
            starts = np.concatenate([[idx[0, 0]], ends[:-1]])
            idx = np.stack([starts, ends], axis=-1)
        data["index"] = idx
    elif "frame_stamps" in data:
        t = np.asarray(data["t"]).reshape(-1, 1)
        data["index"] = frame_event_indices(t, data["frame_stamps"])
    return data


def read_memmap_events_dict(memmap_path, **kwargs):
    """Memmap events in component-dict form (reference read_events.py:95-109,
    with its events-before-assignment bug fixed)."""
    data = read_memmap_events(memmap_path, **kwargs)
    xy = np.asarray(data["xy"])
    return {"xs": xy[:, 0].squeeze(), "ys": xy[:, 1].squeeze(),
            "ts": np.asarray(data["t"]).squeeze(),
            "ps": np.asarray(data["p"]).squeeze()}


# ---------------------------------------------------------------------------
# npy (single (N, 4) array)
# ---------------------------------------------------------------------------

def read_npy_events(npy_path, ts_scale: float = 1e-6):
    """Single-``.npy`` event file: ``(N, 4)`` rows of ``(x, y, p, t_us)``
    (the layout consumed by the reference's NpyDataset, npy_dataset.py:20-37).
    Polarity {0,1} is mapped to {-1,+1}; timestamps scaled to seconds."""
    data = np.load(npy_path)
    xs = data[:, 0]
    ys = data[:, 1]
    ps = data[:, 2] * 2 - 1
    ts = data[:, 3] * ts_scale
    return xs, ys, ts, ps
