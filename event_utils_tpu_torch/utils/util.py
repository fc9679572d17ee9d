"""General utilities: JSON IO, crop geometry, image plotting, flow coloring,
and 8-bit grayscale and RGB PNG writers.

Port of ``event_utils_tpu.utils.util``. Host-side numpy; ``CropParameters``
also pads tensors (on their own device). matplotlib is imported only by
the functions that draw (``plot_image``, ``save_image``,
``plot_image_grid``): the serving and streaming paths write their frames
and flow renderings with ``write_gray_png`` and ``write_rgb_png``, and
``flow2bgr_np`` colors with ``hsv_to_rgb``, which need only numpy and the
standard library.
"""

from __future__ import annotations

import json
import struct
import zlib
from collections import OrderedDict
from math import ceil, floor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def ensure_dir(dirname):
    """Create a directory if missing (reference util.py:15-23)."""
    Path(dirname).mkdir(parents=True, exist_ok=True)


def read_json(fname):
    with Path(fname).open("rt") as handle:
        return json.load(handle, object_hook=OrderedDict)


def write_json(content, fname):
    with Path(fname).open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)


def inf_loop(data_loader):
    """Endless data-loader wrapper (reference util.py:38-41)."""
    from itertools import repeat
    for loader in repeat(data_loader):
        yield from loader


def optimal_crop_size(max_size, max_subsample_factor, safety_margin: int = 0):
    """Smallest integer >= max_size divisible by 2^max_subsample_factor
    (reference util.py:44-51)."""
    crop_size = int(pow(2, max_subsample_factor)
                    * ceil(max_size / pow(2, max_subsample_factor)))
    crop_size += safety_margin * pow(2, max_subsample_factor)
    return crop_size


class CropParameters:
    """Padding/cropping geometry for encoder-decoder networks (E2VID-style;
    reference util.py:54-85). ``pad`` zero-pads a (..., H, W) array or
    tensor to the optimal size; ``crop`` restores the original extent."""

    def __init__(self, width, height, num_encoders, safety_margin: int = 0):
        self.height = height
        self.width = width
        self.num_encoders = num_encoders
        self.width_crop_size = optimal_crop_size(width, num_encoders,
                                                 safety_margin)
        self.height_crop_size = optimal_crop_size(height, num_encoders,
                                                  safety_margin)
        self.padding_top = ceil(0.5 * (self.height_crop_size - height))
        self.padding_bottom = floor(0.5 * (self.height_crop_size - height))
        self.padding_left = ceil(0.5 * (self.width_crop_size - width))
        self.padding_right = floor(0.5 * (self.width_crop_size - width))

        self.cx = floor(self.width_crop_size / 2)
        self.cy = floor(self.height_crop_size / 2)
        self.ix0 = self.cx - floor(width / 2)
        self.ix1 = self.cx + ceil(width / 2)
        self.iy0 = self.cy - floor(height / 2)
        self.iy1 = self.cy + ceil(height / 2)

    def pad(self, img):
        if isinstance(img, torch.Tensor):
            return F.pad(img, (self.padding_left, self.padding_right,
                               self.padding_top, self.padding_bottom))
        pad_spec = ([(0, 0)] * (np.ndim(img) - 2)
                    + [(self.padding_top, self.padding_bottom),
                       (self.padding_left, self.padding_right)])
        return np.pad(np.asarray(img), pad_spec)

    def crop(self, img):
        return img[..., self.iy0:self.iy1, self.ix0:self.ix1]


def format_power(size):
    """Human-readable magnitude (reference util.py:88-95)."""
    power = 1e3
    n = 0
    labels = {0: "", 1: "K", 2: "M", 3: "G", 4: "T"}
    while size > power and n < max(labels):
        size /= power
        n += 1
    return size, labels[n]


def normalize_image(image):
    """Min-max normalise to [0, 1] (the cv.normalize MINMAX equivalent)."""
    image = np.asarray(image, np.float64)
    mn, mx = image.min(), image.max()
    if mx == mn:
        return np.zeros_like(image)
    return (image - mn) / (mx - mn)


def plot_image(image, lognorm=False, cmap="gray", bbox=None, ticks=False,
               norm=True, savename=None, colorbar=False, show=True):
    """Display (and optionally save) an image (reference util.py:97-126)."""
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    fig, ax = plt.subplots(1)
    image = np.asarray(image)
    if lognorm:
        image = np.log10(image)
        cmap = "viridis"
    if norm:
        image = normalize_image(image)
    ims = ax.imshow(image, cmap=cmap)
    if bbox is not None:
        rect = patches.Rectangle((bbox[0], bbox[1]), bbox[2], bbox[3],
                                 linewidth=1, edgecolor="r", facecolor="none")
        ax.add_patch(rect)
    if colorbar:
        fig.colorbar(ims)
    if not ticks:
        plt.axis("off")
    if savename is not None:
        plt.savefig(savename)
    if show:
        plt.show()
    plt.close(fig)


def save_image(image, fname, lognorm=False, cmap="gray", bbox=None,
               colorbar=False):
    """Save an image to disk (reference util.py:168-186)."""
    plot_image(image, lognorm=lognorm, cmap=cmap, bbox=bbox,
               colorbar=colorbar, savename=fname, show=False)


def plot_image_grid(images, grid_shape=None, lognorm=False, cmap="gray",
                    norm=True, savename=None, colorbar=False, show=True):
    """Stitch images into a grid and display/save (reference util.py:128-166)."""
    if grid_shape is None:
        grid_shape = [1, len(images)]
    rows = []
    idx = 0
    blank = np.zeros_like(np.asarray(images[0], np.float64))
    for _ in range(grid_shape[0]):
        row = []
        for _ in range(grid_shape[1]):
            if idx >= len(images):  # grid larger than the image list: pad
                row.append(blank)
                continue
            img = np.asarray(images[idx], np.float64)
            if lognorm:
                img = np.log10(img)
                cmap = "viridis"
            if norm:
                img = normalize_image(img)
            row.append(img)
            idx += 1
        rows.append(np.concatenate(row, axis=1))
    comp = np.concatenate(rows, axis=0)
    plot_image(comp, norm=False, colorbar=colorbar, cmap=cmap,
               savename=savename, show=show)
    return comp


def flow2bgr_np(disp_x, disp_y, max_magnitude=None):
    """Color-code a dense flow field (Zhu/EV-FlowNet convention;
    reference util.py:188-228): hue = direction, value = magnitude.
    Returns uint8 [H, W, 3] in BGR channel order like the reference."""
    disp_x = np.asarray(disp_x)
    disp_y = np.asarray(disp_y)
    assert disp_x.shape == disp_y.shape
    magnitude = np.sqrt(disp_x ** 2 + disp_y ** 2)
    angle = np.arctan2(disp_y, disp_x) + np.pi  # [0, 2pi)

    hue = angle / (2 * np.pi)
    if max_magnitude is None:
        value = normalize_image(magnitude)
    else:
        value = np.clip(magnitude / max_magnitude, 0, 1)
    hsv = np.stack([hue, np.ones_like(hue), value], axis=-1)
    rgb = (hsv_to_rgb(hsv) * 255).astype(np.uint8)
    return rgb[..., ::-1]  # BGR


def hsv_to_rgb(hsv) -> np.ndarray:
    """``matplotlib.colors.hsv_to_rgb`` in numpy (the same arithmetic, in
    the input's float type, at least float32), so that flow renderings need
    no matplotlib. ``hsv`` is (..., 3) with every value in [0, 1]."""
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError(f"hsv_to_rgb needs (..., 3), got {hsv.shape}")
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32), copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # sector i % 6 -> (r, g, b); zero saturation is grey
    sectors = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q)]
    rgb = [np.where(s == 0, v, np.choose(i % 6, [sec[c] for sec in sectors]))
           for c in range(3)]
    return np.stack(rgb, axis=-1).astype(hsv.dtype, copy=False)


def gray_levels(img) -> np.ndarray:
    """uint8 levels of an image in [0, 1], as matplotlib's 256-entry gray
    colormap quantizes it (``plt.imsave(cmap="gray", vmin=0, vmax=1)``):
    ``floor(v * 256)`` clipped to [0, 255]; NaN maps to 0."""
    v = np.nan_to_num(np.asarray(img, np.float64), nan=0.0)
    return np.clip(np.floor(v * 256.0), 0, 255).astype(np.uint8)


def _png(path, levels: np.ndarray, color_type: int) -> None:
    """An 8-bit PNG of ``levels`` ((H, W) gray or (H, W, 3) RGB uint8):
    standard library only (``zlib`` + ``struct``)."""
    H, W = levels.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    # IHDR: width, height, bit depth 8, color type, deflate, adaptive
    # filtering, no interlace; every scanline uses filter 0
    header = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    rows = levels.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_rgb_png(path, rgb) -> None:
    """Write a (H, W, 3) uint8 RGB image as an 8-bit RGB PNG with the
    standard library, where matplotlib is not installed (``plt.imsave`` of
    the same array writes RGBA with the same levels)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_rgb_png needs a (H, W, 3) uint8 image, got "
                         f"{rgb.shape} {rgb.dtype}")
    _png(path, rgb, 2)


def write_gray_png(path, img) -> None:
    """Write a (H, W) image in [0, 1] as an 8-bit grayscale PNG.

    Standard library only (``zlib`` + ``struct``), so frames can be written
    where matplotlib is not installed. The levels are ``gray_levels(img)``;
    they decode to ``plt.imsave(..., cmap="gray", vmin=0, vmax=1)``'s
    within one level.
    """
    levels = gray_levels(img)
    if levels.ndim != 2:
        raise ValueError(f"write_gray_png needs a (H, W) image, got "
                         f"{levels.shape}")
    _png(path, levels, 0)
