"""Object-oriented visualizer family consuming dataloader item dicts (port
of ``event_utils_tpu.visualization.visualizers``; reference
``lib/visualization/visualizers.py``): a registry of renderers keyed by
name, each taking the ``data`` dict of ``BaseVoxelDataset.__getitem__``
and writing one figure per call.

The 2-D visualizers split each figure in two: ``image(data)`` computes the
array on the device (the event image and the voxel grid through the
port's representations, the kernels on the card) and returns it as numpy;
``plot_events`` draws it with matplotlib, imported when called.
"""

from __future__ import annotations

import os

import numpy as np

from .._device import to_numpy
from ..errors import RegistryError
from ..representations.image import TimestampImage, events_to_image
from ..representations.voxel_grid import (events_to_voxel,
                                          get_voxel_grid_as_image)
from ..utils.util import ensure_dir, normalize_image
from .draw_event_stream import plot_events as draw_plot_events
from .draw_event_stream import plot_voxel_grid as draw_plot_voxel


class Visualizer:
    """Renderer contract (reference visualizers.py:16-26). ``device``:
    where the images are computed (default the card; ``"cpu"`` for the
    plain versions)."""

    def __init__(self, sensor_size, device=None):
        self.sensor_size = tuple(sensor_size)
        self.device = device

    def plot_events(self, data, save_path, **kwargs):
        raise NotImplementedError

    @staticmethod
    def unpackage_events(events):
        events = to_numpy(events)
        return (events[:, 0].astype(int), events[:, 1].astype(int),
                events[:, 2], events[:, 3])

    @staticmethod
    def _save(fig_path, dpi=600):
        import matplotlib.pyplot as plt
        ensure_dir(os.path.dirname(fig_path) or ".")
        plt.savefig(fig_path, transparent=True, dpi=dpi, bbox_inches="tight")
        plt.close()

    def _show(self, img, save_path, cmap, figsize=None, dpi=600):
        import matplotlib.pyplot as plt
        plt.figure(figsize=figsize)
        plt.imshow(img, cmap=cmap)
        plt.axis("off")
        self._save(save_path, dpi=dpi)


class TimeStampImageVisualizer(Visualizer):
    """Rank-normalised last-timestamp image (reference
    visualizers.py:28-43; host numpy, as in JAX)."""

    def __init__(self, sensor_size, device=None):
        super().__init__(sensor_size, device)
        self.ts_img = TimestampImage(sensor_size)

    def image(self, data) -> np.ndarray:
        xs, ys, ts, ps = self.unpackage_events(data["events"])
        self.ts_img.set_init(ts[0])
        self.ts_img.add_events(xs, ys, ts, ps)
        return self.ts_img.get_image()

    def plot_events(self, data, save_path, **kwargs):
        self._show(self.image(data), save_path, "viridis")


class EventImageVisualizer(Visualizer):
    """Normalised polarity-accumulation image (reference
    visualizers.py:45-60)."""

    def image(self, data) -> np.ndarray:
        xs, ys, ts, ps = self.unpackage_events(data["events"])
        return normalize_image(to_numpy(events_to_image(
            xs, ys, ps, sensor_size=self.sensor_size, device=self.device)))

    def plot_events(self, data, save_path, **kwargs):
        self._show(self.image(data), save_path, "gray")


class EventsVisualizer(Visualizer):
    """3-D spatiotemporal scatter with frames (reference
    visualizers.py:63-204). The y axis is flipped so the volume renders
    upright."""

    def plot_events(self, data, save_path, num_compress="auto",
                    num_show=1000, event_size=2, elev=0, azim=45,
                    show_events=True, show_frames=True, show_plot=False,
                    crop=None, compress_front=False, marker=".", stride=1,
                    invert=False, show_axes=False, flip_x=False):
        xs, ys, ts, ps = self.unpackage_events(data["events"])
        imgs = data.get("frame", [])
        img_ts = data.get("frame_ts", [])
        if not isinstance(imgs, (list, tuple)):
            imgs, img_ts = [imgs], [img_ts]
        imgs = [to_numpy(im).squeeze() for im in imgs if im is not None]

        ys = self.sensor_size[0] - 1 - ys
        if flip_x:
            xs = self.sensor_size[1] - 1 - xs
        imgs = [np.flip(im, axis=0) for im in imgs]
        if flip_x:
            imgs = [np.flip(im, axis=1) for im in imgs]

        if len(xs) < 2:  # keep the axes well-formed on empty windows
            xs = np.zeros(2)
            ys = np.zeros(2)
            t0 = img_ts[0] if len(img_ts) else 0.0
            ts = np.array([t0, t0 + 1e-6])
            ps = np.zeros(2)

        draw_plot_events(xs, ys, ts, ps, save_path=save_path,
                         num_compress=num_compress, num_show=num_show,
                         event_size=event_size, elev=elev, azim=azim,
                         imgs=imgs, img_ts=img_ts, show_events=show_events,
                         show_frames=show_frames, show_plot=show_plot,
                         crop=crop, compress_front=compress_front,
                         marker=marker, stride=stride, invert=invert,
                         img_size=self.sensor_size, show_axes=show_axes,
                         device=self.device)


class VoxelVisualizer(Visualizer):
    """3-D voxel rendering of each window (reference
    visualizers.py:206-306)."""

    def plot_events(self, data, save_path, bins=5, crop=None, elev=0,
                    azim=45, show_axes=False, show_plot=False, **kwargs):
        xs, ys, ts, ps = self.unpackage_events(data["events"])
        ys = self.sensor_size[0] - 1 - ys
        draw_plot_voxel(xs, ys, ts, ps, bins=bins,
                        sensor_size=self.sensor_size, crop=crop, elev=elev,
                        azim=azim, show_axes=show_axes, save_path=save_path,
                        show_plot=show_plot, device=self.device)


class VoxelImageVisualizer(Visualizer):
    """Bins side by side as one 2-D voxel image (the fast debug view)."""

    def image(self, data, bins=5) -> np.ndarray:
        xs, ys, ts, ps = self.unpackage_events(data["events"])
        vox = events_to_voxel(xs, ys, ts, ps, bins,
                              sensor_size=self.sensor_size,
                              device=self.device)
        return get_voxel_grid_as_image(vox)

    def plot_events(self, data, save_path, bins=5, **kwargs):
        self._show(self.image(data, bins), save_path, "gray",
                   figsize=(3 * bins, 3), dpi=150)


VISUALIZER_REGISTRY = {
    "events": EventsVisualizer,
    "voxels": VoxelVisualizer,
    "voxel_image": VoxelImageVisualizer,
    "event_image": EventImageVisualizer,
    "ts_image": TimeStampImageVisualizer,
}


def get_visualizer(name: str, sensor_size, device=None) -> Visualizer:
    """The registered visualizer ``name`` (``RegistryError`` naming the
    registered ones otherwise)."""
    try:
        cls = VISUALIZER_REGISTRY[name]
    except KeyError:
        raise RegistryError(f"Unknown visualizer {name!r}; have "
                            f"{sorted(VISUALIZER_REGISTRY)}") from None
    return cls(sensor_size, device)
