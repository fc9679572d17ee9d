"""Write events as an RPG-style memmap recording.

Frozen copy of the layout that ``memmap_packager`` in
``event_utils_tpu_torch/data_formats/event_packagers.py`` writes (events
only): ``t.npy`` float64 (N, 1), ``xy.npy`` int16 (N, 2), ``p.npy`` uint8
(N, 1) with 1 for a positive event, and ``metadata.json``. The benchmark
writes its recordings with this copy, so that a change to the program's
packager cannot change the benchmark's inputs.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _sync(path):
    """Flush a file to disk now, in set-up, rather than leave its pages to
    the kernel's writeback during the measured window."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_memmap_recording(path: str, xs, ys, ts, ps, sensor) -> str:
    """Write the events to the directory ``path`` (made if missing)."""
    os.makedirs(path, exist_ok=True)
    n = len(ts)
    cols = (("t", np.float64, (np.asarray(ts, np.float64),)),
            ("xy", np.int16, (xs, ys)),
            ("p", np.uint8, ((np.asarray(ps) > 0),)))
    for name, dtype, parts in cols:
        mm = np.lib.format.open_memmap(os.path.join(path, f"{name}.npy"),
                                       mode="w+", dtype=dtype,
                                       shape=(n, len(parts)))
        for i, a in enumerate(parts):
            mm[:, i] = a
        mm.flush()
        del mm
        _sync(os.path.join(path, f"{name}.npy"))
    ps = np.asarray(ps)
    meta = {"num_events": int(n), "num_pos": int((ps > 0).sum()),
            "num_neg": int((ps <= 0).sum()),
            "duration": float(ts[-1] - ts[0]) if n else 0.0,
            "t0": float(ts[0]) if n else 0.0,
            "tk": float(ts[-1]) if n else 0.0, "num_imgs": 0, "num_flow": 0,
            "index_layout": "start_end_v1",
            "sensor_resolution": [int(s) for s in sensor]}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return path
