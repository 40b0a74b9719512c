"""Planar pixel ops around the LUT core: YUV<->RGB, chroma resampling, range
normalization, and dithered quantization — all jnp elementwise/planar ops that
XLA fuses into memory-bound kernels.

These are the device equivalents of what the reference delegates to FFmpeg's
swscale/zscale (`scale=in_range=...:in_color_matrix=...`, `format=...`,
`zscale=dither=error_diffusion` — src/lut_renderer/ffmpeg.py:211-236, 304-310).
The math mirrors colorcore.matrices exactly (shared constants via the same
module) so host-reference parity holds.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..colorcore import matrices as cm
from ..colorcore.dither import bayer_offsets


def yuv_planes_to_rgb(y, u, v, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    """YUV code-value planes (already co-sited/full-res) -> RGB [0,1] planes."""
    return cm.yuv_to_rgb_planes(y, u, v, matrix, depth, full_range, xp=jnp)


def rgb_to_yuv_planes(r, g, b, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    return cm.rgb_to_yuv_planes(r, g, b, matrix, depth, full_range, xp=jnp)


def range_normalize(y, u, v, depth: int, in_full: bool, out_full: bool):
    if in_full == out_full:
        return y, u, v
    shift = float(1 << (depth - 8))
    c_mid = float(1 << (depth - 1))
    if in_full and not out_full:
        return (
            y * (219.0 / 255.0) + 16.0 * shift,
            (u - c_mid) * (224.0 / 255.0) + c_mid,
            (v - c_mid) * (224.0 / 255.0) + c_mid,
        )
    return (
        (y - 16.0 * shift) * (255.0 / 219.0),
        (u - c_mid) * (255.0 / 224.0) + c_mid,
        (v - c_mid) * (255.0 / 224.0) + c_mid,
    )


def chroma_upsample_420(c, mode: str = "nearest"):
    """(H/2, W/2) chroma plane -> (H, W).

    "nearest" replicates each sample 2x2 (FFmpeg's fast default for
    yuv420p->RGB conversion without accurate-rounding flags); "bilinear" does
    center-sited averaging for higher quality.
    """
    up = jnp.repeat(jnp.repeat(c, 2, axis=-2), 2, axis=-1)
    if mode == "nearest":
        return up
    if mode == "bilinear":
        # Smooth with a separable [1 3 3 1]/8-ish tent via simple neighbor mix
        # on the upsampled grid (half-pel centered chroma siting). Pads only
        # the trailing spatial axes so batched (B, H, W) inputs work.
        pad_cfg = [(0, 0)] * (up.ndim - 2) + [(1, 1), (1, 1)]
        padded = jnp.pad(up, pad_cfg, mode="edge")
        return (
            up * 0.5
            + 0.125 * (padded[..., :-2, 1:-1] + padded[..., 2:, 1:-1]
                       + padded[..., 1:-1, :-2] + padded[..., 1:-1, 2:])
        )
    raise ValueError(f"unknown chroma upsample mode {mode!r}")


def chroma_downsample_420(c):
    """(H, W) chroma plane -> (H/2, W/2) by 2x2 mean (swscale-style box):
    column pairs first, then row pairs. The add grouping is part of the
    numerics: the row-phase layout (ops.render) and the NumPy pipeline
    reference (colorcore.pipeline) use the same order."""
    a = c[..., :, 0::2] + c[..., :, 1::2]
    return (a[..., 0::2, :] + a[..., 1::2, :]) * 0.25


def chroma_resample_422_to_444(c):
    return jnp.repeat(c, 2, axis=-1)


def chroma_downsample_422(c):
    return (c[..., :, 0::2] + c[..., :, 1::2]) * 0.5


_BAYER = None


def _bayer(depth_order: int = 4) -> np.ndarray:
    global _BAYER
    if _BAYER is None:
        _BAYER = bayer_offsets(depth_order)
    return _BAYER


def hash_noise_offsets_jnp(h: int, w: int, plane_seed: int = 0,
                           row_stride: int = 1,
                           row_offset: int = 0) -> jnp.ndarray:
    """jnp twin of colorcore.dither.hash_noise_offsets: zero-mean uniform
    offsets in (-0.5, 0.5) from a stateless murmur3-finalizer position hash —
    identical bits to the NumPy reference so all execution paths agree.

    row_stride/row_offset map plane row r to absolute row r*stride+offset so
    a row-phase half-plane (render._render_rowphase_420) gets the SAME bits
    the full-res plane would at those rows."""
    rows = jax.lax.broadcasted_iota(jnp.uint32, (h, w), 0)
    if row_stride != 1 or row_offset:
        rows = rows * jnp.uint32(row_stride) + jnp.uint32(row_offset)
    cols = jax.lax.broadcasted_iota(jnp.uint32, (h, w), 1)
    x = ((rows * jnp.uint32(0x9E3779B1))
         ^ (cols * jnp.uint32(0x85EBCA77))
         ^ (jnp.uint32(plane_seed) * jnp.uint32(0xC2B2AE3D)))
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).astype(jnp.float32) * jnp.float32(2.0**-24) - 0.5


def quantize_plane(x, depth: int, dither: str = "none",
                   tile_offset: Tuple[int, int] = (0, 0),
                   plane_seed: int = 0,
                   row_stride: int = 1, row_offset: int = 0):
    """Float code values -> integer plane at `depth` bits.

    dither "none": round-to-nearest (floor(x+0.5), FFmpeg convention);
    "ordered": tiled 16x16 Bayer zero-mean offsets added pre-round;
    "random": stateless position-hash uniform offsets (stochastic rounding,
    no tiling structure). Both are parallel substitutes for zscale's serial
    error diffusion (policy note in plan.policy; exact host ED exists via
    native_ext).

    row_stride/row_offset declare that plane row r sits at absolute row
    r*stride+offset of the full-res frame (the row-phase 420 layout); both
    dithers then produce bit-identical offsets to the full-res plane sliced
    at those rows (verified in tests/test_render_rowphase.py).
    """
    maxv = (1 << depth) - 1
    if dither == "ordered":
        pat = _bayer()
        if row_stride != 1 or row_offset:
            if tile_offset != (0, 0):
                raise ValueError("tile_offset with row_stride is unsupported")
            if pat.shape[0] % row_stride or not 0 <= row_offset < row_stride:
                raise ValueError(
                    f"row_stride {row_stride} must divide the "
                    f"{pat.shape[0]}-row dither tile (offset < stride)")
            pat = pat[row_offset::row_stride]
        pat = jnp.asarray(pat)
        th, tw = pat.shape
        h, w = x.shape[-2], x.shape[-1]
        oy, ox = tile_offset
        reps_h = -(-h // th) + 1
        reps_w = -(-w // tw) + 1
        tiled = jnp.tile(pat, (reps_h, reps_w))[oy:oy + h, ox:ox + w]
        x = x + tiled
    elif dither == "random":
        x = x + hash_noise_offsets_jnp(x.shape[-2], x.shape[-1], plane_seed,
                                       row_stride, row_offset)
    out = jnp.clip(jnp.floor(x + 0.5), 0, maxv)
    return out.astype(jnp.uint8 if depth <= 8 else jnp.uint16)


def plane_to_float(x) -> jnp.ndarray:
    return x.astype(jnp.float32)
