"""Resolution rescale (`-s WxH`) as a matmul resampler on the device.

The reference forwards `params.resolution` straight to FFmpeg as `-s WxH`
(src/lut_renderer/ffmpeg.py:312-313), which swscale executes with its default
scaler: SWS_BICUBIC, the Keys bicubic with (B, C) = (0, 0.6). This module
reproduces that scaler exactly as dense separable weight matrices applied as
two matmuls per plane (a 4K->1080p plane costs ~17e9 MACs) instead of
swscale's per-row SIMD convolution loops.

The weight model below was verified tap-for-tap against the bundled
libswscale via impulse-response extraction (hostio.oracle.ScaleOracle,
tests/test_resample.py): FFmpeg computes filter positions in 16.16 fixed
point with C truncation-toward-zero, widens + rescales the kernel argument by
dst/src when downscaling (anti-aliasing), folds out-of-range border taps into
the nearest valid tap (== replicate padding), and normalizes each row to 1
(14-bit fixed point there; f32 here — differences land at ~6e-5/tap, far
below its own coefficient quantization).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

# swscale's default bicubic spline parameters (libswscale SWS_BICUBIC with
# SWS_PARAM_DEFAULT): Keys (B, C) = (0, 0.6).
_B = 0.0
_C = 0.6
_SIZE_FACTOR = 4  # bicubic support (2 px each side)


def _keys(x: float) -> float:
    """Keys BC-spline at |x| (un-normalized by the /6 that cancels in the
    per-row normalization, kept for clarity)."""
    if x < 1.0:
        return ((12 - 9 * _B - 6 * _C) * x * x * x
                + (-18 + 12 * _B + 6 * _C) * x * x
                + (6 - 2 * _B)) / 6.0
    if x < 2.0:
        return ((-_B - 6 * _C) * x * x * x
                + (6 * _B + 30 * _C) * x * x
                + (-12 * _B - 48 * _C) * x
                + (8 * _B + 24 * _C)) / 6.0
    return 0.0


def _trunc_div(n: int, d: int) -> int:
    """C int64 division: truncate toward zero (Python // floors)."""
    q = abs(n) // d
    return q if n >= 0 else -q


@functools.lru_cache(maxsize=64)
def swscale_bicubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) f32 row-stochastic resampling matrix matching FFmpeg's
    default `-s` scaler (SWS_BICUBIC) on this axis.

    Integer phase math mirrors libswscale's initFilter: xInc in 16.16 with
    half-dst rounding; output i's source center (2i+1)*xInc - 2^16 in 2^17
    units; window start trunc-toward-zero; downscale distances scaled by
    dst/src in fixed point; border taps folded to the edge.
    """
    if src <= 0 or dst <= 0:
        raise ValueError(f"bad resample sizes {src}->{dst}")
    xinc = (src * 65536 + (dst >> 1)) // dst
    upscale = xinc <= 65536
    if upscale:
        fsize = 1 + _SIZE_FACTOR
    else:
        fsize = 1 + (_SIZE_FACTOR * src + dst - 1) // dst
    fsize = max(1, min(fsize, src - 2)) if src > 2 else 1

    W = np.zeros((dst, src), np.float64)
    for i in range(dst):
        xdst = (2 * i + 1) * xinc - 65536          # center, 2^17 units
        xx0 = _trunc_div(xdst - (fsize - 2) * 65536, 131072)
        row = W[i]
        for j in range(fsize):
            d = abs((xx0 + j) * 131072 - xdst) << 13   # 2^30 units
            if not upscale:
                d = d * dst // src                     # arg in output px
            row[min(max(xx0 + j, 0), src - 1)] += _keys(d / 1073741824.0)
        s = row.sum()
        if s != 0.0:
            row /= s
        else:  # degenerate (fsize==1 landed on a zero): nearest
            row[min(max(xx0, 0), src - 1)] = 1.0
    return np.ascontiguousarray(W, np.float32)


def resample_weights(in_hw, out_hw):
    """(Wv, Wh) numpy f32 pair for an (H, W) -> (out_h, out_w) resample."""
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    return (swscale_bicubic_weights(in_h, out_h),
            swscale_bicubic_weights(in_w, out_w))


def resample_plane(x, wv, wh):
    """Apply the separable resample to trailing (H, W) axes of `x` (any
    leading batch dims) via two f32 matmuls: Wv @ x @ Wh^T. HIGHEST
    precision keeps full f32 products: a GPU would otherwise be free to run
    f32 matmuls in TF32, whose 10-bit mantissa moves 10-bit code values."""
    xf = x.astype(jnp.float32)
    t = jnp.einsum("ah,...hw->...aw", wv, xf,
                   precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("...aw,bw->...ab", t, wh,
                      precision=lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
