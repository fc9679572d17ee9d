"""Memmap-backed voxel dataset (port of
``event_utils_tpu.data_loaders.memmap_dataset``; reference
lib/data_loaders/memmap_dataset.py).

The preferred format for multi-worker loading, and the one the serving
path reads on a machine without ``h5py``: every component is an
``np.memmap`` handle, so concurrent reads are safe (unlike HDF5 —
reference README.md:125) and nothing loads until sliced.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .base_dataset import BaseVoxelDataset
from ..errors import DataFormatError, DataNotFoundError


class MemMapDataset(BaseVoxelDataset):
    """Voxel dataset over an RPG-style memmap directory
    (reference memmap_dataset.py:5-105)."""

    def get_frame(self, index):
        frame = self.filehandle["images"][index]
        return frame[:, :, 0] if frame.ndim == 3 else frame

    def get_flow(self, index):
        return self.filehandle["optic_flow"][index]

    def get_events(self, idx0, idx1):
        xy = self.filehandle["xy"][idx0:idx1]
        xs = xy[:, 0].astype(np.float32)
        ys = xy[:, 1].astype(np.float32)
        # reshape(-1), not squeeze(): a 1-event window must stay 1-D
        ts = np.asarray(self.filehandle["t"][idx0:idx1]).reshape(-1)
        ps = np.asarray(self.filehandle["p"][idx0:idx1]).reshape(-1) * 2.0 - 1.0
        return xs, ys, ts, ps

    def load_data(self, data_path, timestamp_fname="timestamps.npy",
                  image_fname="images.npy", optic_flow_fname="optic_flow.npy",
                  optic_flow_stamps_fname="optic_flow_timestamps.npy",
                  t_fname="t.npy", xy_fname="xy.npy", p_fname="p.npy"):
        if not os.path.isdir(data_path):
            raise NotADirectoryError(f"{data_path} is not a valid data_path")
        data = {}
        self.has_flow = False
        for subroot, _, fnames in sorted(os.walk(data_path)):
            for fname in sorted(fnames):
                if not fname.endswith(".npy"):
                    continue
                path = os.path.join(subroot, fname)
                # exact-match names: 'optic_flow_timestamps.npy' must not be
                # swallowed by an endswith('timestamps.npy') test (the bug
                # read_events.read_memmap_events avoids with == matching)
                if fname == optic_flow_stamps_fname:
                    data["optic_flow_stamps"] = np.load(path)
                elif fname == timestamp_fname:
                    data["frame_stamps"] = np.load(path)
                elif fname == image_fname:
                    data["images"] = np.load(path, mmap_mode="r")
                elif fname == optic_flow_fname:
                    data["optic_flow"] = np.load(path, mmap_mode="r")
                    self.has_flow = True
                # exact matches throughout: 'warp.npy' endswith 'p.npy' and
                # 'weight.npy' endswith 't.npy' — suffix tests silently load
                # unrelated arrays as event components
                if fname == t_fname:
                    data["t"] = np.load(path, mmap_mode="r").squeeze()
                elif fname == xy_fname:
                    data["xy"] = np.load(path, mmap_mode="r").squeeze()
                elif fname == p_fname:
                    data["p"] = np.load(path, mmap_mode="r").squeeze()
            if "t" in data:
                data["path"] = subroot
                break
        missing = [n for n, k in ((t_fname, "t"), (xy_fname, "xy"),
                                  (p_fname, "p")) if k not in data]
        if missing:
            raise DataNotFoundError(
                f"No complete event data under {data_path} "
                f"(missing {', '.join(missing)})")
        if not (len(data["p"]) == len(data["xy"]) == len(data["t"])):
            raise DataFormatError(
                f"Inconsistent event component lengths under {data_path}")

        self.t0 = float(data["t"][0])
        self.tk = float(data["t"][-1])
        self.num_events = len(data["p"])
        self.num_frames = len(data["images"]) if "images" in data else 0
        self.has_frames = self.num_frames > 0
        self.frame_ts = list(data.get("frame_stamps", []))
        self.filehandle = data
        self.find_config(data_path)

    def find_ts_index(self, timestamp):
        return int(np.searchsorted(self.filehandle["t"], timestamp))

    def ts(self, index):
        return float(self.filehandle["t"][index])

    def infer_resolution(self):
        """Resolution from frames if present, else event extents
        (reference memmap_dataset.py:90-97)."""
        if self.num_frames > 0:
            return list(self.filehandle["images"][0].shape[0:2])
        xy = self.filehandle["xy"]
        return [int(np.max(xy[:, 1])) + 1, int(np.max(xy[:, 0])) + 1]

    def find_config(self, data_path):
        """Optional dataset_config.json sidecar
        (reference memmap_dataset.py:99-105)."""
        self.config = None
        self.data_source = "unknown"
        if self.sensor_resolution is None:
            config = os.path.join(data_path, "dataset_config.json")
            if os.path.exists(config):
                with open(config) as f:
                    self.config = json.load(f)
                self.data_source = self.config.get("data_source", "unknown")
                from .data_util import data_sources
                if self.data_source in data_sources:
                    self.data_source_idx = data_sources.index(
                        self.data_source)
            from .data_util import memmap_sensor_resolution
            res = memmap_sensor_resolution(data_path)
            self.sensor_resolution = (list(res) if res is not None
                                      else self.infer_resolution())
