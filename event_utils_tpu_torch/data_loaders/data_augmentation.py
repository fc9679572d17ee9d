"""Transforms for voxel/frame/flow items.

Port of ``event_utils_tpu.data_loaders.data_augmentation`` (reference
``lib/data_loaders/data_augmentation.py``): transforms take numpy arrays or
torch tensors shaped ``(C, H, W)``, return the same kind (a tensor stays on
its device), and keep the reference's flow-aware ``__call__(x,
is_flow=False)`` protocol.
"""

from __future__ import annotations

import numbers
from typing import Optional, Sequence

import numpy as np
import torch

from ..errors import ConfigurationError, RegistryError


class Compose:
    """Chain transforms (reference data_augmentation.py:6-39)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, is_flow: bool = False):
        for t in self.transforms:
            x = t(x, is_flow)
        return x

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


class CenterCrop:
    """Center-crop a (C, H, W) array (reference data_augmentation.py:42-80),
    with the mosaicing-pattern-preserving even-offset option."""

    def __init__(self, size, preserve_mosaicing_pattern: bool = False):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = tuple(size)
        self.preserve_mosaicing_pattern = preserve_mosaicing_pattern

    def __call__(self, x, is_flow: bool = False):
        h, w = x.shape[1], x.shape[2]
        th, tw = self.size
        if th > h or tw > w:
            raise ConfigurationError(
                f"CenterCrop size {self.size} exceeds input {(h, w)}")
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        if self.preserve_mosaicing_pattern:
            i += i % 2
            j += j % 2
        return x[:, i:i + th, j:j + tw]

    def __repr__(self):
        return f"{self.__class__.__name__}(size={self.size})"


class RandomCrop:
    """Random crop (the stochastic complement of CenterCrop).

    Offsets come from the stdlib ``random`` module by default, as in the
    JAX package: ``BaseVoxelDataset._apply`` synchronizes an item's
    voxel/frame/flow transforms by re-seeding ``random`` with a shared
    per-item seed, so a module-level draw gives all three the SAME crop
    window, and the same seed gives the same window in both packages. Pass
    an explicit ``rng`` only for standalone use outside the dataset."""

    def __init__(self, size, rng: Optional[np.random.Generator] = None):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = tuple(size)
        self.rng = rng

    def __call__(self, x, is_flow: bool = False):
        import random

        h, w = x.shape[1], x.shape[2]
        th, tw = self.size
        if th > h or tw > w:
            raise ConfigurationError(
                f"RandomCrop size {self.size} exceeds input {(h, w)}")
        if self.rng is not None:
            i = int(self.rng.integers(0, h - th + 1))
            j = int(self.rng.integers(0, w - tw + 1))
        else:
            i = random.randint(0, h - th)
            j = random.randint(0, w - tw)
        return x[:, i:i + th, j:j + tw]


class RobustNorm:
    """Percentile-clamped normalisation (reference data_augmentation.py:83-136).

    Nearest-rank percentiles (the reference's ``kthvalue`` semantics) and
    the reference's exact normalisation ``(clamped - min) / (max + eps)``.
    A tensor is normalised on its device, a numpy array on the host.
    """

    def __init__(self, low_perc: float = 0, top_perc: float = 95):
        self.low_perc = low_perc
        self.top_perc = top_perc

    @staticmethod
    def _rank(size: int, q) -> int:
        return 1 + round(0.01 * float(q) * (size - 1))

    @classmethod
    def percentile(cls, t, q):
        if isinstance(t, torch.Tensor):
            flat = t.reshape(-1)
            return float(flat.kthvalue(cls._rank(flat.numel(), q)).values)
        t = np.asarray(t)
        k = cls._rank(t.size, q)
        return float(np.partition(t.reshape(-1), k - 1)[k - 1])

    def __call__(self, x, is_flow: bool = False):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        t_max = self.percentile(x, self.top_perc)
        t_min = self.percentile(x, self.low_perc)
        if t_max == 0 and t_min == 0:
            return x
        eps = 1e-6
        if isinstance(x, torch.Tensor):
            normed = x.clamp(t_min, t_max)
        else:
            normed = np.clip(x, t_min, t_max)
        return (normed - normed.min()) / (normed.max() + eps)

    def __repr__(self):
        return (f"{self.__class__.__name__}(top_perc={self.top_perc:.2f}, "
                f"low_perc={self.low_perc:.2f})")


TRANSFORM_REGISTRY = {
    "Compose": Compose,
    "CenterCrop": CenterCrop,
    "RandomCrop": RandomCrop,
    "RobustNorm": RobustNorm,
}


def build_transform(name: str, **kwargs):
    """Explicit registry lookup — replaces the reference's
    ``eval(name)(**kwargs)`` stringly-typed construction
    (base_dataset.py:190-195)."""
    try:
        cls = TRANSFORM_REGISTRY[name]
    except KeyError:
        raise RegistryError(
            f"Unknown transform {name!r}; have {sorted(TRANSFORM_REGISTRY)}"
        ) from None
    return cls(**kwargs)
