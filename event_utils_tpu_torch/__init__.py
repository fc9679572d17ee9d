"""event_utils_tpu_torch — the PyTorch/CUDA port of event_utils_tpu.

A second package beside the JAX one, for an NVIDIA H100. It imports
``torch`` and never ``jax`` or ``event_utils_tpu``, and has a counterpart
of every module of the JAX package: the contrast-maximisation path over
dense event representations, the learned-model serving path (recording
-> dataset -> voxel grid -> EV-FlowNet / E2VID with the JAX package's
weights), the event simulator with its consumers, training (also
data-parallel), streaming ingest (the native window runtime,
pinned-memory device prefetch, ``stream_flow``), the augmentation path
(the data-format converters, host and device augmentation with the
nearly-sorted densify sort, ``augment_demo``), multi-card sharding on
``torch.distributed`` and visualization.

- ``ops``             scatter-add, gather, scipy-parity Gaussian blur, the
                      background-activity filter, the nearly-sorted time
                      sorts, and the hand-written CUDA accumulation kernels
                      (``csrc/scatter_kernels.cu``) with their plain versions
- ``augmentation``    host (numpy) and device (torch) event augmentation,
                      the 2x densify with its packed sort
- ``utils``           event masks / clipping / windowing / lifespan cuts,
                      crop geometry, JSON and PNG helpers, PSNR/SSIM/AEE,
                      throughput meters and profiler traces
- ``native``          the C++ ingest runtime (``csrc/evio.cpp``, built by
                      ``g++`` at first use): window tables, padded batch
                      assembly, ROI bucket fill
- ``representations`` event image, average-timestamp image, voxel grids
- ``models``          parametric warp models + contrast objectives, and the
                      EV-FlowNet / E2VID networks
- ``contrast_max``    scipy-driven and whole-solve optimizers, grid search
- ``data_formats``    HDF5 / memmap / npy readers and packagers, and the
                      converters (ECD text, HDF5 <-> memmap, rosbag)
- ``data_loaders``    windowed voxel datasets, transforms, collation, the
                      streaming window loaders and ``device_prefetch``
- ``transforms``      dense-flow event warping
- ``training``        the flow and E2VID trainers, in the loop and on
                      recordings
- ``simulation``      the ESIM-style event simulator and its scenes, with
                      the JAX package's textures as data
- ``visualization``   3-D event-cloud, voxel and flow renders, motion
                      compensation, the visualizer registry (matplotlib
                      and mayavi imported when drawing)
- ``cli``             ``infer_flow``, ``reconstruct``, ``simulate``,
                      ``eval_cmax``, ``stream_flow``, ``train_flow``,
                      ``train_reconstruction``, ``augment_demo``,
                      ``cmax_demo`` and the ``visualize*`` renderers
- ``parallel``        multi-card meshes on ``torch.distributed``:
                      event-sharded images, the sharded train step,
                      ROI-sharded ``grid_cmax``
- ``convert``         warps/objectives from JAX instances, and JAX
                      ``params.npz`` weights into the networks

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
``DeviceUnavailableError`` without one; pass ``device="cpu"`` for the plain
versions on the host. Tensors that come in keep their device.
"""

__version__ = "0.1.0"

from . import errors  # noqa: F401
from . import ops, utils, representations, models, contrast_max  # noqa: F401
from . import data_formats, data_loaders, transforms, training  # noqa: F401
from . import simulation, convert, native  # noqa: F401
from . import augmentation, parallel, visualization  # noqa: F401
