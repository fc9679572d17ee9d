"""Add/modify attributes on HDF5 event files
(reference lib/data_formats/add_hdf5_attribute.py).

Port of ``event_utils_tpu.data_formats.add_hdf5_attribute`` (a copy;
``h5py`` is imported only by ``add_attribute``)."""

from __future__ import annotations

import os
from typing import Iterable, List


def get_filepaths_from_path_or_file(path, extension: str = ".h5",
                                    datafile_extension: str = ".txt") -> List[str]:
    """Resolve a file, directory, or list-file into a list of H5 paths
    (reference add_hdf5_attribute.py:13-26)."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, p) for p in os.listdir(path)
                      if p.endswith(extension))
    if path.endswith(datafile_extension):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return [path]


def add_attribute(paths: Iterable[str], attr_name: str, attr_value,
                  group: str = "/", dry_run: bool = False):
    """Set ``attr_name = attr_value`` on ``group`` of each file
    (reference add_hdf5_attribute.py:28-37)."""
    import h5py
    for path in paths:
        if dry_run:
            print(f"[dry run] {path}:{group}@{attr_name} = {attr_value}")
            continue
        with h5py.File(path, "a") as f:
            f[group].attrs[attr_name] = attr_value


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Add an attribute to HDF5 event files")
    parser.add_argument("path", help="H5 file, directory, or .txt list")
    parser.add_argument("attr_name")
    parser.add_argument("attr_value")
    parser.add_argument("--group", default="/")
    parser.add_argument("--type", default="str",
                        choices=["str", "int", "float", "int_list",
                                 "float_list"])
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    cast = {"str": str, "int": int, "float": float,
            "int_list": lambda s: [int(v) for v in s.split(",")],
            "float_list": lambda s: [float(v) for v in s.split(",")]}[args.type]
    paths = get_filepaths_from_path_or_file(args.path)
    add_attribute(paths, args.attr_name, cast(args.attr_value),
                  group=args.group, dry_run=args.dry_run)


if __name__ == "__main__":
    main()
