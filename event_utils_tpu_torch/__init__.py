"""event_utils_tpu_torch — the PyTorch/CUDA port of event_utils_tpu.

A second package beside the JAX one, for an NVIDIA H100. It imports
``torch`` and never ``jax`` or ``event_utils_tpu``. Ported so far: the
contrast-maximisation path over dense event representations.

- ``ops``             scatter-add, gather, scipy-parity Gaussian blur, and
                      the hand-written CUDA accumulation kernels
                      (``csrc/scatter_kernels.cu``) with their plain versions
- ``utils``           event masks / clipping / windowing / lifespan cuts
- ``representations`` event image, average-timestamp image, voxel grids
- ``models``          parametric warp models + contrast objectives
- ``contrast_max``    scipy-driven and whole-solve optimizers, grid search
- ``convert``         build the port's warps/objectives from JAX instances

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
``DeviceUnavailableError`` without one; pass ``device="cpu"`` for the plain
versions on the host. Tensors that come in keep their device.
"""

__version__ = "0.1.0"

from . import errors  # noqa: F401
from . import ops, utils, representations, models, contrast_max  # noqa: F401
from . import convert  # noqa: F401
