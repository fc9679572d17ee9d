"""Windowed voxel datasets over memmap, HDF5 and npy recordings, their
transforms and collation helpers; the streaming window loaders on the
native runtime (``NativeWindowedLoader``, ``H5WindowedLoader``,
``ChainLoader``), the threaded ``EventDataLoader`` and the pinned-memory
``device_prefetch``.
"""

from .base_dataset import BaseVoxelDataset  # noqa: F401
from .data_augmentation import (  # noqa: F401
    CenterCrop,
    Compose,
    RandomCrop,
    RobustNorm,
    TRANSFORM_REGISTRY,
    build_transform,
)
from .data_util import (  # noqa: F401
    ConcatDataset,
    concatenate_datasets,
    concatenate_memmap_datasets,
    concatenate_subfolders,
    data_sources,
    memmap_sensor_resolution,
)
from .dataloader_util import unpack_batched_events  # noqa: F401
from .hdf5_dataset import DynamicH5Dataset  # noqa: F401
from .memmap_dataset import MemMapDataset  # noqa: F401
from .native_loader import (  # noqa: F401
    ChainLoader,
    H5WindowedLoader,
    NativeWindowedLoader,
)
from .npy_dataset import NpyDataset  # noqa: F401
from .prefetch import EventDataLoader, device_prefetch  # noqa: F401
