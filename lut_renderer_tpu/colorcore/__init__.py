"""colorcore — pure color math: .cube parsing, YUV<->RGB matrices, range
transforms, reference 3D-LUT interpolators, and color-difference metrics.

This layer is the correctness anchor for the whole framework: the jitted XLA
pipeline in `ops` and the host oracle in `hostio` are both validated against it.
It depends only on numpy (and optionally jax for the jnp variants).
"""

from .cube import Lut3D, parse_cube, parse_cube_file, write_cube_file
from .matrices import (
    MATRIX_COEFFS,
    range_normalize_yuv,
    rgb_to_yuv_planes,
    yuv_to_rgb_planes,
)
from .interp import (
    INTERP_MODES,
    apply_lut_nearest,
    apply_lut_tetrahedral,
    apply_lut_trilinear,
    apply_lut,
)
from .metrics import delta_e76, max_delta_e76, psnr

__all__ = [
    "Lut3D",
    "parse_cube",
    "parse_cube_file",
    "write_cube_file",
    "MATRIX_COEFFS",
    "range_normalize_yuv",
    "rgb_to_yuv_planes",
    "yuv_to_rgb_planes",
    "INTERP_MODES",
    "apply_lut_nearest",
    "apply_lut_trilinear",
    "apply_lut_tetrahedral",
    "apply_lut",
    "delta_e76",
    "max_delta_e76",
    "psnr",
]
