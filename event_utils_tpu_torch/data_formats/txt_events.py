"""Plain-text event IO (ECD / rpg-style ``events.txt``).

Port of ``event_utils_tpu.data_formats.txt_events`` (a copy: the module is
host-side numpy and pandas; ``h5py`` is imported only by ``txt_to_h5``,
through ``hdf5_packager``, and ``cv2`` only for ``images.txt`` frames).

New component with no reference counterpart, but squarely in the
reference's ecosystem: the recordings its demos run on (slider_depth,
dynamic_rotation — Event Camera Dataset, rpg.ifi.uzh.ch) are distributed
as text files with one ``t x y p`` line per event (t in seconds,
p in {0, 1}), plus an ``images.txt`` of ``t filename`` rows. This module
reads/writes that layout and converts it into the framework's native HDF5
via the standard packager (`event_packagers.hdf5_packager`), so a user can
go straight from a public download to every loader/CLI here.

Parsing streams through pandas' C reader in bounded chunks — a 1e8-event
recording never materializes as text rows in memory. ``.gz`` files are
handled transparently (pandas infers compression from the suffix).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..errors import DataFormatError, DataNotFoundError

_COLUMNS = ("ts", "xs", "ys", "ps")


def _read_chunks(txt_path, chunk_rows: int):
    import pandas as pd
    try:
        reader = pd.read_csv(txt_path, sep=r"\s+", header=None,
                             names=_COLUMNS, dtype=np.float64,
                             comment="#", chunksize=chunk_rows)
    except FileNotFoundError:
        raise DataNotFoundError(f"no such event file: {txt_path}")
    try:
        for chunk in reader:
            if chunk.isna().to_numpy().any():
                raise DataFormatError(
                    f"{txt_path}: malformed rows — expected 4 numeric "
                    "columns (t x y p) per line")
            yield (chunk["xs"].to_numpy(), chunk["ys"].to_numpy(),
                   chunk["ts"].to_numpy(), chunk["ps"].to_numpy())
    except (pd.errors.ParserError, ValueError) as e:
        if isinstance(e, DataFormatError):
            raise
        raise DataFormatError(f"{txt_path}: not parseable as t x y p "
                              f"rows ({e})")


def read_txt_events(txt_path, chunk_rows: int = 5_000_000
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Read an ECD-style ``events.txt`` (lines of ``t x y p``).

    Returns ``(xs, ys, ts, ps)`` with the framework conventions: int64
    coords, float64 seconds, polarity mapped ``{0,1} -> {-1,+1}`` exactly
    as the H5 readers do (read_events.py).
    """
    parts = list(_read_chunks(txt_path, chunk_rows))
    if not parts:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z, z
    xs = np.concatenate([p[0] for p in parts]).astype(np.int64)
    ys = np.concatenate([p[1] for p in parts]).astype(np.int64)
    ts = np.concatenate([p[2] for p in parts])
    ps = np.concatenate([p[3] for p in parts])
    ps = np.where(ps > 0, 1.0, -1.0)
    return xs, ys, ts, ps


def write_txt_events(txt_path, xs, ys, ts, ps) -> None:
    """Write an ECD-style ``events.txt`` (polarity stored as {0, 1})."""
    import pandas as pd
    df = pd.DataFrame({
        "ts": np.asarray(ts, np.float64),
        "xs": np.asarray(xs).astype(np.int64),
        "ys": np.asarray(ys).astype(np.int64),
        "ps": (np.asarray(ps) > 0).astype(np.int64),
    })
    df.to_csv(txt_path, sep=" ", header=False, index=False,
              float_format="%.9f")


def read_images_txt(images_txt: str):
    """Parse an ECD ``images.txt`` (lines of ``t filename``)."""
    stamps, names = [], []
    try:
        with open(images_txt) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, name = line.split(maxsplit=1)
                stamps.append(float(t))
                names.append(name)
    except FileNotFoundError:
        raise DataNotFoundError(f"no such images index: {images_txt}")
    return np.asarray(stamps, np.float64), names


def txt_to_h5(txt_path, output_path, images_txt: Optional[str] = None,
              sensor_size: Optional[Tuple[int, int]] = None,
              chunk_rows: int = 5_000_000, zero_timestamps: bool = False,
              ) -> str:
    """Convert ``events.txt`` (+ optional ``images.txt`` frames) to the
    Monash-layout HDF5 every loader here consumes.

    Events stream through in ``chunk_rows`` blocks; frames referenced by
    ``images.txt`` are loaded relative to its directory (grayscale).
    Returns the output path.
    """
    from .event_packagers import hdf5_packager

    pk = hdf5_packager(output_path)
    num = num_pos = 0
    t0 = tk = None
    t_offset = 0.0
    max_x = max_y = 0
    for xs, ys, ts, ps in _read_chunks(txt_path, chunk_rows):
        if t0 is None:
            if zero_timestamps:
                t_offset = ts[0]
            t0 = ts[0] - t_offset
        ts = ts - t_offset
        tk = ts[-1]
        pk.package_events(xs.astype(np.int64), ys.astype(np.int64), ts,
                          np.where(ps > 0, 1.0, -1.0))
        num += len(ts)
        num_pos += int((ps > 0).sum())
        if len(xs):
            max_x = max(max_x, int(xs.max()))
            max_y = max(max_y, int(ys.max()))
    if num == 0:
        raise DataFormatError(f"{txt_path} contains no events")

    num_imgs = 0
    if images_txt is not None:
        import cv2
        pk.set_data_available(num_images=1, num_flow=0)
        stamps, names = read_images_txt(images_txt)
        base = os.path.dirname(os.path.abspath(images_txt))
        for k, (t, name) in enumerate(zip(stamps, names)):
            img = cv2.imread(os.path.join(base, name),
                             cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise DataNotFoundError(
                    f"images.txt references unreadable frame: {name}")
            pk.package_image(img, float(t - t_offset), img_idx=k)
            num_imgs += 1

    if sensor_size is None:
        sensor_size = (max_y + 1, max_x + 1)
    pk.add_metadata(num_events=num, num_pos=num_pos, num_neg=num - num_pos,
                    duration=tk - t0, t0=t0, tk=tk, num_imgs=num_imgs,
                    num_flow=0, sensor_size=sensor_size)
    pk.close()
    return output_path


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Convert ECD-style events.txt (+ images.txt) to HDF5")
    parser.add_argument("txt_path", help="events.txt (optionally .gz)")
    parser.add_argument("output_path", help="Output .h5 file")
    parser.add_argument("--images_txt", default=None,
                        help="Optional images.txt (t filename per line)")
    parser.add_argument("--sensor", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="Sensor size (default: inferred from events)")
    parser.add_argument("--zero_timestamps", action="store_true",
                        help="Shift timestamps so the first event is t=0")
    parser.add_argument("--chunk_rows", type=int, default=5_000_000)
    args = parser.parse_args(argv)
    txt_to_h5(args.txt_path, args.output_path, images_txt=args.images_txt,
              sensor_size=(tuple(args.sensor) if args.sensor else None),
              chunk_rows=args.chunk_rows,
              zero_timestamps=args.zero_timestamps)
    print(f"wrote {args.output_path}")


if __name__ == "__main__":
    main()
