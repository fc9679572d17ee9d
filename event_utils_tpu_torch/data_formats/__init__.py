"""File-format IO: HDF5/memmap/npy readers and streaming packagers.

The converters of the JAX package (``h5_to_memmap``, ``memmap_to_h5``,
``txt_events``, ``rosbag_to_h5``, ``add_hdf5_attribute``) are not ported
yet.
"""

from .read_events import (  # noqa: F401
    compute_indices,
    frame_event_indices,
    read_h5_event_components,
    read_h5_events,
    read_h5_events_dict,
    read_memmap_events,
    read_memmap_events_dict,
    read_npy_events,
)
from .event_packagers import hdf5_packager, memmap_packager, packager  # noqa: F401
