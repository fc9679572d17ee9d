"""event_utils_tpu_torch — the PyTorch/CUDA port of event_utils_tpu.

A second package beside the JAX one, for an NVIDIA H100. It imports
``torch`` and never ``jax`` or ``event_utils_tpu``. Ported so far: the
contrast-maximisation path over dense event representations, the
learned-model serving path (recording -> dataset -> voxel grid ->
EV-FlowNet / E2VID with the JAX package's weights), and the event
simulator with its consumers.

- ``ops``             scatter-add, gather, scipy-parity Gaussian blur, the
                      background-activity filter, and
                      the hand-written CUDA accumulation kernels
                      (``csrc/scatter_kernels.cu``) with their plain versions
- ``utils``           event masks / clipping / windowing / lifespan cuts,
                      crop geometry, JSON and PNG helpers, PSNR/SSIM/AEE
- ``representations`` event image, average-timestamp image, voxel grids
- ``models``          parametric warp models + contrast objectives, and the
                      EV-FlowNet / E2VID networks
- ``contrast_max``    scipy-driven and whole-solve optimizers, grid search
- ``data_formats``    HDF5 / memmap / npy readers and packagers
- ``data_loaders``    windowed voxel datasets, transforms, collation
- ``transforms``      dense-flow event warping
- ``training``        inference surface of the flow and E2VID trainers
- ``simulation``      the ESIM-style event simulator and its scenes, with
                      the JAX package's textures as data
- ``cli``             ``infer_flow``, ``reconstruct``, ``simulate`` and
                      ``eval_cmax``
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
from . import simulation, convert  # noqa: F401
