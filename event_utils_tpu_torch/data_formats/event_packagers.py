"""Write-side packagers: stream events/frames/flow into HDF5 or memmap files.

Port of ``event_utils_tpu.data_formats.event_packagers`` (a copy: the
module is host-side numpy; ``h5py`` is imported only by ``hdf5_packager``).
Both write byte-for-byte what the JAX package's packagers write. Rebuild of
reference ``lib/data_formats/event_packagers.py`` (ABC at :6-80, HDF5 impl
at :82-157) plus a memmap packager, so both on-disk layouts the readers
understand can also be written.

On-disk schema (HDF5), identical to the reference: chunked resizable
``events/{xs int16, ys int16, ts float64, ps bool}``; ``images/image{:09d}``
and ``flow/flow{:09d}`` datasets with ``timestamp``/``size`` (+``event_idx``)
attrs; file attrs ``num_events/num_pos/num_neg/duration/t0/tk/num_imgs/
num_flow/sensor_resolution``.
"""

from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod

import numpy as np


class packager(ABC):
    """Contract for streaming dataset writers (reference
    event_packagers.py:6-80)."""

    def __init__(self, name, output_path, max_buffer_size: int = 1000000):
        self.name = name
        self.output_path = output_path
        self.max_buffer_size = max_buffer_size

    @abstractmethod
    def package_events(self, xs, ys, ts, ps):
        ...

    @abstractmethod
    def package_image(self, frame, timestamp):
        ...

    @abstractmethod
    def package_flow(self, flow, timestamp):
        ...

    @abstractmethod
    def add_metadata(self, num_events, num_pos, num_neg, duration, t0, tk,
                     num_imgs, num_flow):
        ...

    @abstractmethod
    def set_data_available(self, num_images, num_flow):
        ...

    def close(self):
        """Release file handles; safe to call more than once. Subclasses
        with on-disk state override this."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class hdf5_packager(packager):
    """Stream events into a Monash-layout HDF5 file
    (reference event_packagers.py:82-157)."""

    def __init__(self, output_path, max_buffer_size: int = 1000000):
        import h5py
        super().__init__("hdf5", output_path, max_buffer_size)
        self.file = h5py.File(output_path, "w")
        self.event_xs = self.file.create_dataset(
            "events/xs", (0,), dtype=np.dtype(np.int16), maxshape=(None,),
            chunks=True)
        self.event_ys = self.file.create_dataset(
            "events/ys", (0,), dtype=np.dtype(np.int16), maxshape=(None,),
            chunks=True)
        self.event_ts = self.file.create_dataset(
            "events/ts", (0,), dtype=np.dtype(np.float64), maxshape=(None,),
            chunks=True)
        self.event_ps = self.file.create_dataset(
            "events/ps", (0,), dtype=np.dtype(np.bool_), maxshape=(None,),
            chunks=True)
        self.image_dset = None
        self.flow_dset = None

    @staticmethod
    def _append(dataset, data):
        data = np.asarray(data)
        n = dataset.shape[0]
        dataset.resize((n + len(data),))
        if len(data):
            dataset[n:] = data

    def package_events(self, xs, ys, ts, ps):
        self._append(self.event_xs, xs)
        self._append(self.event_ys, ys)
        self._append(self.event_ts, ts)
        self._append(self.event_ps, np.asarray(ps) > 0)

    def package_image(self, image, timestamp, img_idx=None):
        if img_idx is None:
            img_idx = len(self.file.get("images", {}))
        dset = self.file.create_dataset(f"images/image{img_idx:09d}",
                                        data=image, dtype=np.dtype(np.uint8))
        dset.attrs["size"] = np.asarray(image).shape
        dset.attrs["timestamp"] = timestamp
        dset.attrs["type"] = ("greyscale" if np.asarray(image).ndim == 2
                              else "color_frame")

    def package_flow(self, flow_image, timestamp, flow_idx=None):
        if flow_idx is None:
            flow_idx = len(self.file.get("flow", {}))
        dset = self.file.create_dataset(f"flow/flow{flow_idx:09d}",
                                        data=flow_image)
        dset.attrs["size"] = np.asarray(flow_image).shape
        dset.attrs["timestamp"] = timestamp

    def add_event_indices(self):
        """Back-fill each image's ``event_idx`` attr by chunked searchsorted
        over the (possibly huge) timestamp dataset
        (reference event_packagers.py:120-137)."""
        chunk_size = 100000
        n = self.event_ts.shape[0]
        if "images" not in self.file or n == 0:
            return
        stamps = np.asarray([self.file[f"images/{k}"].attrs["timestamp"]
                             for k in sorted(self.file["images"])])
        indices = np.zeros(len(stamps), dtype=np.int64)
        done = np.zeros(len(stamps), dtype=bool)
        offset = 0
        for start in range(0, n, chunk_size):
            chunk = self.event_ts[start:start + chunk_size]
            local = np.searchsorted(chunk, stamps)
            inside = (~done) & (local < len(chunk))
            indices[inside] = offset + local[inside]
            done |= inside
            offset += len(chunk)
        indices[~done] = n - 1
        for k, idx in zip(sorted(self.file["images"]), indices):
            self.file[f"images/{k}"].attrs["event_idx"] = int(idx)

    def add_metadata(self, num_events, num_pos, num_neg, duration, t0, tk,
                     num_imgs, num_flow, sensor_size=None):
        self.file.attrs["num_events"] = num_events
        self.file.attrs["num_pos"] = num_pos
        self.file.attrs["num_neg"] = num_neg
        self.file.attrs["duration"] = duration
        self.file.attrs["t0"] = t0
        self.file.attrs["tk"] = tk
        self.file.attrs["num_imgs"] = num_imgs
        self.file.attrs["num_flow"] = num_flow
        if sensor_size is not None:
            self.file.attrs["sensor_resolution"] = sensor_size
        self.add_event_indices()

    def set_data_available(self, num_images, num_flow):
        if num_images > 0:
            self.file.require_group("images")
        if num_flow > 0:
            self.file.require_group("flow")

    def close(self):
        if self.file:  # h5py truthiness: False once closed
            self.file.close()


class memmap_packager(packager):
    """Stream events into an RPG-style memmap directory (new component —
    writes the layout that ``read_memmap_events`` consumes:
    ``t.npy (float64 Nx1), xy.npy (int16 Nx2), p.npy (uint8 Nx1)`` plus
    frames/flow stacks and ``metadata.json``).

    Events genuinely stream: each ``package_events`` call appends converted
    raw bytes to spill files on disk, and ``add_metadata`` finalizes them
    into ``.npy`` files by chunked memmap copy — RAM stays O(chunk)
    regardless of stream length (frames/flow, typically few and small, are
    buffered)."""

    _SPILLS = (("t", np.float64, 1), ("xy", np.int16, 2), ("p", np.uint8, 1))

    def __init__(self, output_dir, max_buffer_size: int = 1000000):
        super().__init__("memmap", output_dir, max_buffer_size)
        os.makedirs(output_dir, exist_ok=True)
        self._spill = {name: open(os.path.join(output_dir, f".{name}.bin"),
                                  "wb") for name, _, _ in self._SPILLS}
        self._num_events = 0
        self._images, self._image_ts = [], []
        self._flows, self._flow_ts = [], []

    def package_events(self, xs, ys, ts, ps):
        xs = np.asarray(xs)
        self._spill["t"].write(
            np.ascontiguousarray(np.asarray(ts, np.float64)).tobytes())
        self._spill["xy"].write(np.ascontiguousarray(
            np.stack([xs, np.asarray(ys)], -1).astype(np.int16)).tobytes())
        self._spill["p"].write(np.ascontiguousarray(
            (np.asarray(ps) > 0).astype(np.uint8)).tobytes())
        self._num_events += len(xs)

    def package_image(self, image, timestamp, img_idx=None):
        self._images.append(np.asarray(image))
        self._image_ts.append(timestamp)

    def package_flow(self, flow, timestamp, flow_idx=None):
        self._flows.append(np.asarray(flow))
        self._flow_ts.append(timestamp)

    def set_data_available(self, num_images, num_flow):
        pass

    def close(self):
        """Close spill handles and sweep leftover partial ``.{t,xy,p}.bin``
        files (abandoned stream / error path). A no-op after
        ``add_metadata`` finalized — the real ``.npy`` outputs are kept."""
        for name, _, _ in self._SPILLS:
            fh = self._spill.get(name)
            if fh is not None and not fh.closed:
                fh.close()
            spill_path = os.path.join(self.output_path, f".{name}.bin")
            if os.path.exists(spill_path):
                os.remove(spill_path)

    def _finalize_events(self):
        """Spill files -> proper .npy memmaps, chunked (O(chunk) RAM)."""
        out = self.output_path
        n = self._num_events
        chunk = max(1, int(self.max_buffer_size))
        for name, dtype, width in self._SPILLS:
            self._spill[name].close()
            spill_path = os.path.join(out, f".{name}.bin")
            npy_path = os.path.join(out, f"{name}.npy")
            if n == 0:  # an empty file cannot be mmapped
                np.save(npy_path, np.zeros((0, width), dtype))
                os.remove(spill_path)
                continue
            mm = np.lib.format.open_memmap(npy_path, mode="w+", dtype=dtype,
                                           shape=(n, width))
            with open(spill_path, "rb") as f:
                row = np.dtype(dtype).itemsize * width
                for start in range(0, n, chunk):
                    m = min(chunk, n - start)
                    buf = np.frombuffer(f.read(m * row), dtype=dtype)
                    mm[start:start + m] = buf.reshape(m, width)
            mm.flush()
            del mm
            os.remove(spill_path)

    def add_metadata(self, num_events, num_pos, num_neg, duration, t0, tk,
                     num_imgs, num_flow, sensor_size=None):
        out = self.output_path
        self._finalize_events()
        if self._images:
            np.save(os.path.join(out, "images.npy"),
                    np.stack(self._images))
            np.save(os.path.join(out, "timestamps.npy"),
                    np.asarray(self._image_ts))
            from .read_events import frame_event_indices
            t_mm = np.load(os.path.join(out, "t.npy"), mmap_mode="r")
            index = frame_event_indices(t_mm, np.asarray(self._image_ts))
            np.save(os.path.join(out, "index.npy"), index)
        if self._flows:
            np.save(os.path.join(out, "optic_flow.npy"),
                    np.stack(self._flows))
            np.save(os.path.join(out, "optic_flow_timestamps.npy"),
                    np.asarray(self._flow_ts))
        meta = {"num_events": int(num_events), "num_pos": int(num_pos),
                "num_neg": int(num_neg), "duration": float(duration),
                "t0": float(t0), "tk": float(tk), "num_imgs": int(num_imgs),
                "num_flow": int(num_flow),
                # layout marker: index.npy row i is the canonical
                # (start, end) range of events UP TO frame i — lets readers
                # skip the ambiguous-layout heuristic (see
                # read_events._normalize_frame_index)
                "index_layout": "start_end_v1"}
        if sensor_size is not None:
            meta["sensor_resolution"] = list(int(s) for s in sensor_size)
        with open(os.path.join(out, "metadata.json"), "w") as f:
            json.dump(meta, f)
