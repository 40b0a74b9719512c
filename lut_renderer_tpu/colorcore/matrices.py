"""YCbCr <-> RGB matrix math and full/limited range transforms.

In the reference these conversions happen inside FFmpeg's swscale, steered by the
policy engine via `scale=in_color_matrix=...:out_color_matrix=...` and
`in_range=pc:out_range=tv` filter args (reference: src/lut_renderer/ffmpeg.py:
211-236) plus the matrix whitelist at ffmpeg.py:113-126. Here they are explicit
float math, shared by the NumPy reference path and the device pipeline.

Conventions:
  * Code values are float arrays carrying integer code points at bit depth `d`
    (e.g. 0..255 for 8-bit, 0..1023 for 10-bit).
  * "tv"/limited range: Y in [16, 235]*2^(d-8), C in [16, 240]*2^(d-8).
  * "pc"/full range:    Y in [0, 2^d-1],        C centered at 2^(d-1).
  * RGB is normalized float in [0, 1] (the 3D LUT's input/output domain).

Matrix names mirror the reference's whitelist (ffmpeg.py:119-125):
bt709, smpte170m, bt470bg, bt2020nc, bt2020c (nc math used for 'c' as well —
constant-luminance BT.2020 is not emitted by any policy path).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# name -> (Kr, Kb)
MATRIX_COEFFS: Dict[str, Tuple[float, float]] = {
    "bt709": (0.2126, 0.0722),
    "smpte170m": (0.299, 0.114),
    "bt601": (0.299, 0.114),
    "bt470bg": (0.299, 0.114),
    "bt2020nc": (0.2627, 0.0593),
    "bt2020c": (0.2627, 0.0593),
}

DEFAULT_MATRIX = "bt709"


def _range_params(depth: int, full_range: bool) -> Tuple[float, float, float, float]:
    """Return (y_offset, y_scale, c_mid, c_scale) in code values at `depth`."""
    shift = float(1 << (depth - 8))
    c_mid = float(1 << (depth - 1))
    if full_range:
        y_off = 0.0
        y_scale = float((1 << depth) - 1)
        c_scale = float((1 << depth) - 1)
    else:
        y_off = 16.0 * shift
        y_scale = 219.0 * shift
        c_scale = 224.0 * shift
    return y_off, y_scale, c_mid, c_scale


def yuv_rgb_coeffs(matrix: str) -> Tuple[float, float, float, float, float]:
    """Return (Kr, Kg, Kb, 2*(1-Kr), 2*(1-Kb)) for the named matrix."""
    kr, kb = MATRIX_COEFFS.get(matrix.lower(), MATRIX_COEFFS[DEFAULT_MATRIX])
    kg = 1.0 - kr - kb
    return kr, kg, kb, 2.0 * (1.0 - kr), 2.0 * (1.0 - kb)


def yuv_to_rgb_planes(y, u, v, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False, xp=np):
    """Planar YUV code values -> normalized RGB in [0,1] (unclipped is clamped).

    Works for numpy or jax.numpy via the `xp` module argument so the identical
    math serves both the reference path and traced JAX code.
    """
    kr, kg, kb, crv, cbu = yuv_rgb_coeffs(matrix)
    y_off, y_scale, c_mid, c_scale = _range_params(depth, full_range)
    yn = (y - y_off) / y_scale
    un = (u - c_mid) / c_scale
    vn = (v - c_mid) / c_scale
    r = yn + crv * vn
    b = yn + cbu * un
    g = yn - (kr * crv / kg) * vn - (kb * cbu / kg) * un
    clip = xp.clip
    return clip(r, 0.0, 1.0), clip(g, 0.0, 1.0), clip(b, 0.0, 1.0)


def rgb_to_yuv_planes(r, g, b, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False, xp=np):
    """Normalized RGB in [0,1] -> planar YUV code values (float, unquantized)."""
    kr, kg, kb, crv, cbu = yuv_rgb_coeffs(matrix)
    y_off, y_scale, c_mid, c_scale = _range_params(depth, full_range)
    yn = kr * r + kg * g + kb * b
    vn = (r - yn) / crv
    un = (b - yn) / cbu
    y = yn * y_scale + y_off
    u = un * c_scale + c_mid
    v = vn * c_scale + c_mid
    return y, u, v


def range_normalize_yuv(y, u, v, depth: int, in_full: bool, out_full: bool):
    """Convert YUV code values between full(pc) and limited(tv) range in-place
    semantics of FFmpeg `scale=in_range=...:out_range=...` (swscale lumRange/
    chrRange conversion). Returns float (caller quantizes).

    Reference policy: yuvj*/pc sources are normalized before the LUT
    (src/lut_renderer/ffmpeg.py:212-233, detection at ffmpeg.py:129-134).
    """
    if in_full == out_full:
        return y, u, v
    shift = float(1 << (depth - 8))
    c_mid = float(1 << (depth - 1))
    if in_full and not out_full:  # pc -> tv
        y2 = y * (219.0 / 255.0) + 16.0 * shift
        u2 = (u - c_mid) * (224.0 / 255.0) + c_mid
        v2 = (v - c_mid) * (224.0 / 255.0) + c_mid
    else:  # tv -> pc
        y2 = (y - 16.0 * shift) * (255.0 / 219.0)
        u2 = (u - c_mid) * (255.0 / 224.0) + c_mid
        v2 = (v - c_mid) * (255.0 / 224.0) + c_mid
    return y2, u2, v2
