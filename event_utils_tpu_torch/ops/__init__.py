"""Device kernels: scatter-add, gather, Gaussian blur, and the hand-written
CUDA accumulation kernels with their plain versions."""

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
from .cuda_scatter import (  # noqa: F401
    bilinear_matmul,
    image_matmul,
    launch_counts,
    reset_launch_counts,
    scatter_add_flat_cuda,
    voxel_matmul,
)
