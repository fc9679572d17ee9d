"""File-format IO: HDF5/memmap/npy readers, streaming packagers, and the
converters (ECD ``events.txt``, HDF5 <-> memmap, rosbag, HDF5 attributes).
``h5py`` is imported only by the functions that read or write HDF5."""

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
from .txt_events import (  # noqa: F401
    read_images_txt,
    read_txt_events,
    txt_to_h5,
    write_txt_events,
)
from .event_packagers import hdf5_packager, memmap_packager, packager  # noqa: F401
from .h5_to_memmap import find_safe_alternative, h5_to_memmap  # noqa: F401
from .memmap_to_h5 import memmap_to_h5  # noqa: F401
from .rosbag_to_h5 import BagExtractor, extract_rosbag, extract_rosbags  # noqa: F401
from .add_hdf5_attribute import (  # noqa: F401
    add_attribute,
    get_filepaths_from_path_or_file,
)
