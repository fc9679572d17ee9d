"""rosbag -> HDF5 extraction (reference lib/data_formats/rosbag_to_h5.py).

Port of ``event_utils_tpu.data_formats.rosbag_to_h5`` (a copy: host-side
numpy; ``h5py`` is imported only by ``hdf5_packager``).

ROS (``rosbag``/``cv_bridge``) is not installed beside the card, so the
ROS-specific message iteration is isolated behind an import gate: the
extraction logic itself (``extract_events``) is testable without ROS by
feeding it message dicts, and ``extract_rosbag`` wires it to a real bag when
rosbag is importable.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from .event_packagers import hdf5_packager


def _have_ros():
    try:
        import rosbag  # noqa: F401
        return True
    except ImportError:
        return False


class BagExtractor:
    """Streams event/image/flow messages into a packager with bounded
    buffers (the write-path of reference rosbag_to_h5.py:43-139; the
    reference's 1e20 buffer size effectively never flushed — catalogued bug,
    fixed with a real default)."""

    def __init__(self, packager, zero_timestamps: bool = False,
                 max_buffer_size: int = 1_000_000, sensor_size=None):
        self.packager = packager
        self.zero_timestamps = zero_timestamps
        self.max_buffer_size = max_buffer_size
        self.sensor_size = sensor_size
        self.xs, self.ys, self.ts, self.ps = [], [], [], []
        self.num_pos = 0
        self.num_neg = 0
        self.num_events = 0
        self.num_imgs = 0
        self.num_flow = 0
        self.t0 = None
        self.tk = None
        self.max_x = self.max_y = 0

    def _maybe_zero(self, t):
        if self.t0 is None:
            self.t0 = t
        self.tk = t
        return t - self.t0 if self.zero_timestamps else t

    def add_event(self, x, y, t, p):
        t = self._maybe_zero(t)
        self.xs.append(x)
        self.ys.append(y)
        self.ts.append(t)
        self.ps.append(1 if p else 0)
        self.num_events += 1
        if p:
            self.num_pos += 1
        else:
            self.num_neg += 1
        self.max_x = max(self.max_x, x)
        self.max_y = max(self.max_y, y)
        if len(self.xs) >= self.max_buffer_size:
            self.flush_events()

    def add_events(self, xs, ys, ts, ps):
        for x, y, t, p in zip(xs, ys, ts, ps):
            self.add_event(x, y, t, p)

    def add_image(self, image, t):
        t = self._maybe_zero(t)
        if self.sensor_size is None:
            self.sensor_size = np.asarray(image).shape[:2]
        self.packager.package_image(image, t, self.num_imgs)
        self.num_imgs += 1

    def add_flow(self, flow, t):
        t = self._maybe_zero(t)
        self.packager.package_flow(flow, t, self.num_flow)
        self.num_flow += 1

    def flush_events(self):
        if self.xs:
            self.packager.package_events(self.xs, self.ys, self.ts, self.ps)
            self.xs, self.ys, self.ts, self.ps = [], [], [], []

    def finalize(self):
        self.flush_events()
        if self.sensor_size is None:
            self.sensor_size = (self.max_y + 1, self.max_x + 1)
        t0 = 0 if self.zero_timestamps or self.t0 is None else self.t0
        tk = (self.tk - self.t0 if self.zero_timestamps else self.tk) or 0
        self.packager.set_data_available(self.num_imgs, self.num_flow)
        self.packager.add_metadata(self.num_events, self.num_pos,
                                   self.num_neg, (tk - t0), t0, tk,
                                   self.num_imgs, self.num_flow,
                                   sensor_size=list(self.sensor_size))


def extract_rosbag(rosbag_path, output_path, event_topic,
                   image_topic: Optional[str] = None,
                   flow_topic: Optional[str] = None,
                   zero_timestamps: bool = False,
                   max_buffer_size: int = 1_000_000):
    """Extract one bag into an H5 file (reference rosbag_to_h5.py:43-139).

    Requires the ``rosbag`` + ``cv_bridge`` packages; raises a clear error
    otherwise.
    """
    if not _have_ros():
        raise ImportError(
            "rosbag/cv_bridge are not installed in this environment. "
            "Run this converter on a machine with ROS, or convert via "
            "another tool into the HDF5 layout (events/{xs,ys,ts,ps}).")
    import rosbag
    from cv_bridge import CvBridge

    bridge = CvBridge()
    ep = hdf5_packager(output_path)
    ex = BagExtractor(ep, zero_timestamps=zero_timestamps,
                      max_buffer_size=max_buffer_size)
    topics = [t for t in (event_topic, image_topic, flow_topic) if t]
    with rosbag.Bag(rosbag_path, "r") as bag:
        for topic, msg, _ in bag.read_messages(topics=topics):
            if topic == event_topic:
                for e in msg.events:
                    ex.add_event(e.x, e.y, e.ts.to_sec(), e.polarity)
            elif topic == image_topic:
                image = bridge.imgmsg_to_cv2(msg, "mono8")
                ex.add_image(image, msg.header.stamp.to_sec())
            elif topic == flow_topic:
                flow = np.stack([
                    np.asarray(msg.flow_x).reshape(msg.height, msg.width),
                    np.asarray(msg.flow_y).reshape(msg.height, msg.width)])
                ex.add_flow(flow, msg.header.stamp.to_sec())
    ex.finalize()
    ep.close()
    return output_path


def extract_rosbags(rosbag_paths: Iterable[str], output_dir, event_topic,
                    **kwargs):
    """Batch extraction (reference rosbag_to_h5.py:142-149)."""
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    for path in rosbag_paths:
        out = os.path.join(
            output_dir, os.path.splitext(os.path.basename(path))[0] + ".h5")
        outputs.append(extract_rosbag(path, out, event_topic, **kwargs))
    return outputs


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Extract rosbags into HDF5")
    parser.add_argument("path", help="Bag file or directory of bags")
    parser.add_argument("--output_dir", default="/tmp/extracted_data")
    parser.add_argument("--event_topic", default="/dvs/events")
    parser.add_argument("--image_topic", default=None)
    parser.add_argument("--flow_topic", default=None)
    parser.add_argument("--zero_timestamps", action="store_true")
    args = parser.parse_args(argv)
    paths = ([args.path] if os.path.isfile(args.path) else
             [os.path.join(args.path, p) for p in sorted(os.listdir(args.path))
              if p.endswith(".bag")])
    extract_rosbags(paths, args.output_dir, args.event_topic,
                    image_topic=args.image_topic, flow_topic=args.flow_topic,
                    zero_timestamps=args.zero_timestamps)


if __name__ == "__main__":
    main()
