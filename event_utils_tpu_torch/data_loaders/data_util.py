"""Dataset concatenation helpers (reference lib/data_loaders/data_util.py).

Port of ``event_utils_tpu.data_loaders.data_util`` (a copy): a minimal
``ConcatDataset`` implementing the sequence protocol, so concatenations
work standalone or under a ``torch.utils.data.DataLoader``.
"""

from __future__ import annotations

import bisect
import csv
import os
from typing import Sequence
from ..errors import ConfigurationError, DataNotFoundError

data_sources = ("esim", "ijrr", "mvsec", "eccd", "hqfd", "unknown")


def memmap_sensor_resolution(data_path):
    """The ``sensor_resolution`` recorded next to a memmap directory, or
    ``None``.

    Single source of truth for the sidecar precedence —
    ``dataset_config.json`` beats ``metadata.json`` — shared by
    ``MemMapDataset.find_config`` and the streaming CLIs (a recording
    whose motion never reaches the last rows/cols would be undersized by
    coordinate extents)."""
    import json

    for name in ("dataset_config.json", "metadata.json"):
        path = os.path.join(data_path, name)
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f).get("sensor_resolution")
            if res is not None:
                return int(res[0]), int(res[1])
    return None


class ConcatDataset:
    """Concatenation of sequence-protocol datasets."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ConfigurationError(
                "ConcatDataset needs at least one dataset")
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - offset]


def _paths_from_file_or_dir(data_file):
    if os.path.isdir(data_file):
        return sorted(os.path.join(data_file, s) for s in os.listdir(data_file))
    if os.path.isfile(data_file):
        with open(data_file) as f:
            return [row[0] for row in csv.reader(f) if row]
    raise DataNotFoundError(
        f"{data_file} must be a list file or a base folder")


def concatenate_subfolders(data_file, dataset, dataset_kwargs=None,
                           path_key: str = "data_path"):
    """Aggregate every dataset root under a folder (or csv list) into one
    ConcatDataset (reference data_util.py:11-26). Identical semantics to
    :func:`concatenate_datasets` (the reference keeps both names)."""
    return concatenate_datasets(data_file, dataset, dataset_kwargs,
                                path_key=path_key)


def concatenate_datasets(data_file, dataset_type, dataset_kwargs=None,
                         path_key: str = "data_path"):
    """One dataset per path listed in ``data_file``, concatenated
    (reference data_util.py:29-47)."""
    dataset_kwargs = dict(dataset_kwargs or {})
    paths = _paths_from_file_or_dir(data_file)
    datasets = []
    for p in paths:
        kw = dict(dataset_kwargs)
        kw[path_key] = p
        datasets.append(dataset_type(**kw))
    return ConcatDataset(datasets)


# memmap roots use the same mechanism; kept for API parity
concatenate_memmap_datasets = concatenate_datasets
