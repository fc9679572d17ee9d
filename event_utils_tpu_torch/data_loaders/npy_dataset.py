"""Single-.npy voxel dataset (port of
``event_utils_tpu.data_loaders.npy_dataset``; reference
lib/data_loaders/npy_dataset.py).

File layout: one ``(N, 4)`` array of rows ``(x, y, p, t_microseconds)``;
polarity {0,1} -> {-1,+1}, timestamps scaled to seconds.
"""

from __future__ import annotations

import numpy as np

from .base_dataset import BaseVoxelDataset


class NpyDataset(BaseVoxelDataset):
    """Voxel dataset over a single .npy event array
    (reference npy_dataset.py:4-53; no frames or flow)."""

    def get_frame(self, index):
        return None

    def get_flow(self, index):
        return None

    def get_events(self, idx0, idx1):
        return (self.xs[idx0:idx1], self.ys[idx0:idx1],
                self.tss[idx0:idx1], self.ps[idx0:idx1])

    def load_data(self, data_path):
        data = np.load(data_path)
        self.xs = data[:, 0]
        self.ys = data[:, 1]
        self.ps = data[:, 2] * 2 - 1
        self.tss = data[:, 3] * 1e-6
        if self.sensor_resolution is None:
            self.sensor_resolution = [int(np.max(self.ys)) + 1,
                                      int(np.max(self.xs)) + 1]
        else:
            self.sensor_resolution = self.sensor_resolution[0:2]
        self.has_flow = False
        self.has_frames = False
        self.t0 = self.tss[0]
        self.tk = self.tss[-1]
        self.num_events = len(self.xs)
        self.num_frames = 0
        self.frame_ts = []

    def find_ts_index(self, timestamp):
        return int(np.searchsorted(self.tss, timestamp))

    def ts(self, index):
        return self.tss[index]
