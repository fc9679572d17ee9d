"""A configuration's recording, made from the seed into a work directory,
and its raw events read back (for the references, which never read them
through the program)."""

from __future__ import annotations

import os

import numpy as np

from gen.memmap_writer import write_memmap_recording
from gen.rotating_stream import rotating_stream


def make_recording(cfg: dict, seed: int, workdir: str) -> str:
    scene = cfg["scene"]
    xs, ys, ts, ps = rotating_stream(
        seed, int(cfg["num_events"]), sensor=tuple(cfg["sensor"]),
        omega=scene["omega_rad_s"], points=scene["points"],
        draws_per_s=scene["draws_per_s"], jitter=scene["jitter_px"])
    return write_memmap_recording(os.path.join(workdir, "recording"), xs, ys,
                                  ts, ps, cfg["sensor"])


def raw_events(path: str, i0: int, i1: int):
    """Events ``[i0, i1)`` of a recording as float32 ``(x, y, t, p)``,
    polarity in {-1, 1}."""
    t = np.load(os.path.join(path, "t.npy"), mmap_mode="r")[i0:i1, 0]
    xy = np.load(os.path.join(path, "xy.npy"), mmap_mode="r")[i0:i1]
    p = np.load(os.path.join(path, "p.npy"), mmap_mode="r")[i0:i1, 0]
    return (xy[:, 0].astype(np.float32), xy[:, 1].astype(np.float32),
            np.asarray(t).astype(np.float32),
            np.where(p > 0, 1.0, -1.0).astype(np.float32))
