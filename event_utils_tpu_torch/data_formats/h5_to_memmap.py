"""HDF5 -> memmap conversion CLI (reference lib/data_formats/h5_to_memmap.py).

Port of ``event_utils_tpu.data_formats.h5_to_memmap`` (a copy: host-side
numpy; ``h5py`` is imported only by ``h5_to_memmap``).

Writes ``t.npy (float64 Nx1), xy.npy (int16 Nx2), p.npy (uint8 Nx1)`` plus
image/flow stacks, ``index.npy`` and ``metadata.json``. Event indices use
int64 (the reference's uint16 overflows past 65535 events/frame,
h5_to_memmap.py:45 — catalogued bug, fixed here).
"""

from __future__ import annotations

import json
import os

import numpy as np


def find_safe_alternative(output_base_path):
    """Non-clobbering output path (reference h5_to_memmap.py:18-25)."""
    if not os.path.exists(output_base_path):
        return output_base_path
    i = 0
    alternative = f"{output_base_path}_{i}"
    while os.path.exists(alternative):
        i += 1
        alternative = f"{output_base_path}_{i}"
    return alternative


def h5_to_memmap(h5_path, output_dir, overwrite: bool = False,
                 chunk_size: int = 5_000_000):
    """Convert one Monash-layout H5 file into an RPG-style memmap directory
    (reference h5_to_memmap.py:27-126), streaming events in chunks so
    arbitrarily large files convert in bounded memory."""
    import h5py

    if os.path.exists(output_dir) and not overwrite:
        output_dir = find_safe_alternative(output_dir)
    os.makedirs(output_dir, exist_ok=True)

    from .read_events import _h5_event_datasets

    with h5py.File(h5_path, "r") as f:
        dx, dy, dt, dp = _h5_event_datasets(f)
        n = dt.shape[0]

        t_mm = np.lib.format.open_memmap(
            os.path.join(output_dir, "t.npy"), mode="w+",
            dtype=np.float64, shape=(n, 1))
        xy_mm = np.lib.format.open_memmap(
            os.path.join(output_dir, "xy.npy"), mode="w+",
            dtype=np.int16, shape=(n, 2))
        p_mm = np.lib.format.open_memmap(
            os.path.join(output_dir, "p.npy"), mode="w+",
            dtype=np.uint8, shape=(n, 1))
        for s in range(0, n, chunk_size):
            e = min(s + chunk_size, n)
            t_mm[s:e, 0] = dt[s:e]
            xy_mm[s:e, 0] = dx[s:e]
            xy_mm[s:e, 1] = dy[s:e]
            p_mm[s:e, 0] = (np.asarray(dp[s:e]) > 0).astype(np.uint8)
        del t_mm, xy_mm, p_mm

        num_imgs = num_flow = 0
        if "images" in f:
            keys = sorted(f["images"])
            num_imgs = len(keys)
            if num_imgs:
                imgs = np.stack([f[f"images/{k}"][:] for k in keys])
                stamps = np.asarray(
                    [f[f"images/{k}"].attrs["timestamp"] for k in keys])
                eidx = np.asarray(
                    [f[f"images/{k}"].attrs.get("event_idx", 0) for k in keys],
                    dtype=np.int64)
                np.save(os.path.join(output_dir, "images.npy"), imgs)
                np.save(os.path.join(output_dir, "timestamps.npy"), stamps)
                # canonical (F, 2) (start, end) table: frame i's events are
                # [end_{i-1}, event_idx_i) — the between_frames convention
                # (see read_events.frame_event_indices)
                np.save(os.path.join(output_dir, "index.npy"),
                        np.stack([np.concatenate([[0], eidx[:-1]]), eidx],
                                 axis=-1))
        if "flow" in f:
            keys = sorted(f["flow"])
            num_flow = len(keys)
            if num_flow:
                flows = np.stack([f[f"flow/{k}"][:] for k in keys])
                fstamps = np.asarray(
                    [f[f"flow/{k}"].attrs["timestamp"] for k in keys])
                np.save(os.path.join(output_dir, "optic_flow.npy"), flows)
                np.save(os.path.join(output_dir, "optic_flow_timestamps.npy"),
                        fstamps)

        write_metadata(f, output_dir, n, num_imgs, num_flow)
    return output_dir


def write_metadata(h5_file, output_dir, num_events, num_imgs, num_flow):
    """metadata.json sidecar (reference h5_to_memmap.py:63-71)."""
    meta = {"num_events": int(num_events), "num_imgs": int(num_imgs),
            "num_flow": int(num_flow),
            # canonical index.npy layout marker (row i = (start, end) of
            # events up to frame i); readers use it to skip the ambiguous
            # layout heuristic in read_events._normalize_frame_index
            "index_layout": "start_end_v1"}
    for key in ("num_pos", "num_neg", "duration", "t0", "tk",
                "sensor_resolution"):
        if key in h5_file.attrs:
            val = h5_file.attrs[key]
            meta[key] = (val.tolist() if isinstance(val, np.ndarray)
                         else (float(val) if np.issubdtype(type(val), np.floating)
                               else int(val)))
    with open(os.path.join(output_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Convert Monash-layout HDF5 event files to RPG memmaps")
    parser.add_argument("path", help="H5 file or directory of H5 files")
    parser.add_argument("--output_dir", default=None,
                        help="Output root (default: alongside input)")
    parser.add_argument("--not_overwrite", action="store_true")
    args = parser.parse_args(argv)

    paths = ([args.path] if os.path.isfile(args.path) else
             [os.path.join(args.path, p) for p in sorted(os.listdir(args.path))
              if p.endswith((".h5", ".hdf5"))])
    for p in paths:
        out = (os.path.splitext(p)[0] + "_memmap" if args.output_dir is None
               else os.path.join(args.output_dir,
                                 os.path.splitext(os.path.basename(p))[0]))
        print(f"{p} -> {h5_to_memmap(p, out, overwrite=not args.not_overwrite)}")


if __name__ == "__main__":
    main()
