"""Memmap -> HDF5 conversion CLI (the reverse of ``h5_to_memmap``).

Port of ``event_utils_tpu.data_formats.memmap_to_h5`` (a copy: host-side
numpy; ``h5py`` is imported only by ``hdf5_packager``).

New component with no reference counterpart: the reference converts only
rosbag->H5->memmap, so RPG-style memmap recordings could never reach
H5-only consumers. Streams the event components in chunks through
`event_packagers.hdf5_packager` (bounded RAM) and carries frames/flow and
metadata across.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .event_packagers import hdf5_packager
from .read_events import read_memmap_events


def memmap_to_h5(memmap_dir, output_path, chunk_size: int = 5_000_000) -> str:
    data = read_memmap_events(memmap_dir)
    pk = hdf5_packager(output_path)
    n = data["num_events"]
    t = data["t"]
    xy = data["xy"]
    p = data["p"]
    num_pos = 0
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        ps = np.asarray(p[s:e]).reshape(-1)
        num_pos += int((ps > 0).sum())
        pk.package_events(np.asarray(xy[s:e, 0]).reshape(-1),
                          np.asarray(xy[s:e, 1]).reshape(-1),
                          np.asarray(t[s:e]).reshape(-1), ps)

    num_imgs = num_flow = 0
    if "images" in data and "frame_stamps" in data:
        pk.set_data_available(num_images=1, num_flow=0)
        for k, (img, ft) in enumerate(zip(data["images"],
                                          data["frame_stamps"])):
            img = np.asarray(img)
            if img.dtype != np.uint8:
                # float frames normalized to [0, 1] scale up; anything
                # already in [0, 255] just clips
                if np.issubdtype(img.dtype, np.floating) and img.max() <= 1.0:
                    img = img * 255.0
                img = np.clip(img, 0, 255).astype(np.uint8)
            pk.package_image(img, float(np.asarray(ft).squeeze()), img_idx=k)
            num_imgs += 1
    if "optic_flow" in data and "optic_flow_stamps" in data:
        pk.set_data_available(num_images=num_imgs, num_flow=1)
        for k, (fl, ft) in enumerate(zip(data["optic_flow"],
                                         data["optic_flow_stamps"])):
            pk.package_flow(np.asarray(fl, np.float32),
                            float(np.asarray(ft).squeeze()), flow_idx=k)
            num_flow += 1

    t0 = float(np.asarray(t[0]).squeeze()) if n else 0.0
    tk = float(np.asarray(t[n - 1]).squeeze()) if n else 0.0
    sensor = None
    # sidecars live NEXT TO the component files (read_memmap_events may
    # resolve them in a nested subdir of the user-supplied root), then
    # next to the root; frames carry the exact shape; event maxima are
    # the last resort (they underestimate when border pixels never fire)
    for base in (data["path"], memmap_dir):
        for name in ("dataset_config.json", "metadata.json"):
            mp = os.path.join(base, name)
            if sensor is None and os.path.exists(mp):
                import json
                with open(mp) as f:
                    meta = json.load(f)
                if "sensor_resolution" in meta:
                    sensor = tuple(int(v)
                                   for v in meta["sensor_resolution"][:2])
    if sensor is None and num_imgs:
        sensor = tuple(np.asarray(data["images"][0]).shape[:2])
    if sensor is None and n:
        xs_max = int(np.asarray(xy[:, 0]).max())
        ys_max = int(np.asarray(xy[:, 1]).max())
        sensor = (ys_max + 1, xs_max + 1)
    pk.add_metadata(num_events=n, num_pos=num_pos, num_neg=n - num_pos,
                    duration=tk - t0, t0=t0, tk=tk, num_imgs=num_imgs,
                    num_flow=num_flow, sensor_size=sensor)
    pk.close()
    return output_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert an RPG-style memmap directory to Monash HDF5")
    parser.add_argument("memmap_dir")
    parser.add_argument("output_path", help="Output .h5 file")
    parser.add_argument("--chunk_size", type=int, default=5_000_000)
    args = parser.parse_args(argv)
    memmap_to_h5(args.memmap_dir, args.output_path,
                 chunk_size=args.chunk_size)
    print(f"wrote {args.output_path}")


if __name__ == "__main__":
    main()
