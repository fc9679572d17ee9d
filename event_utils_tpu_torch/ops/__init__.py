"""Device kernels: scatter-add, gather, Gaussian blur, the background-
activity filter, the hand-written CUDA accumulation kernels with their
plain versions, the full-frame bilinear scatter of the matmul signature,
and the nearly-sorted time sorts (``ops.sort``)."""

from .scatter import (  # noqa: F401
    bilinear_gather,
    bilinear_scatter,
    bilinear_scatter_derivative,
    get_default_impl,
    scatter_add_2d,
    scatter_add_flat,
    set_default_impl,
)
from .blur import gaussian_filter, gaussian_blur_image, gaussian_kernel1d  # noqa: F401
from .denoise import (  # noqa: F401
    background_activity_filter,
    filter_background_activity,
)
from .matmul_scatter import bilinear_scatter_matmul  # noqa: F401
from .cuda_scatter import (  # noqa: F401
    bilinear_matmul,
    image_matmul,
    launch_counts,
    reset_launch_counts,
    scatter_add_flat_cuda,
    voxel_matmul,
    voxel_matmul_batched,
    voxel_matmul_tiles,
)
