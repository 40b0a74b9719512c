"""Dither patterns for bit-depth reduction.

The reference exposes `zscale=dither=error_diffusion` (src/lut_renderer/
ffmpeg.py:304-307; param default "none" at models.py:46). True error diffusion
is a row-recurrent serial algorithm — hostile to data-parallel hardware — so
the device pipeline substitutes spatially-stationary dithers applied inside
the jitted render step:

  * "none":    round-to-nearest quantization;
  * "ordered": 16x16 Bayer threshold matrix (tiled), zero-mean;
  * "random":  per-pixel uniform offsets from a stateless position hash
               (murmur3-finalizer avalanche over (row, col, plane_seed)) —
               stochastic rounding that is bit-reproducible across runs and
               across the XLA / NumPy implementations (a stateful
               PRNG would diverge between them).

The deviation from zscale's error diffusion is deliberate and documented; the
acceptance budget is the same dE76 < 0.5 bound as the LUT itself. Exact host
error diffusion exists separately (native/src/dither_ed.cpp).
"""

from __future__ import annotations

import numpy as np

DITHER_MODES = ("none", "ordered", "random", "error_diffusion")

# murmur3/lowbias32 avalanche constants, shared verbatim with ops.pixel's jnp
# implementation so all paths produce identical offsets.
_H_ROW = np.uint32(0x9E3779B1)
_H_COL = np.uint32(0x85EBCA77)
_H_SEED = np.uint32(0xC2B2AE3D)
_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)


def hash_noise_offsets(h: int, w: int, plane_seed: int = 0) -> np.ndarray:
    """Zero-mean uniform dither offsets in (-0.5, 0.5), shape (h, w).

    Stateless position hash: every (row, col, plane_seed) triple maps to one
    fixed offset, so the pattern is reproducible and tile-free (no visible
    Bayer structure). NumPy reference for the jnp/kernel implementations."""
    rows = np.arange(h, dtype=np.uint32)[:, None]
    cols = np.arange(w, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        x = (rows * _H_ROW) ^ (cols * _H_COL) ^ (np.uint32(plane_seed) * _H_SEED)
        x ^= x >> np.uint32(16)
        x *= _M1
        x ^= x >> np.uint32(15)
        x *= _M2
        x ^= x >> np.uint32(16)
    # top 24 bits -> uniform in [0, 1) at f32 resolution, then center
    return ((x >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)
            - np.float32(0.5))


def quantize_with_random_dither(x: np.ndarray, depth: int,
                                plane_seed: int = 0) -> np.ndarray:
    """NumPy reference for the kernel's "random" dither path."""
    h, w = x.shape[-2], x.shape[-1]
    maxv = (1 << depth) - 1
    noise = hash_noise_offsets(h, w, plane_seed)
    return np.clip(np.floor(x + 0.5 + noise), 0, maxv).astype(
        np.uint16 if depth > 8 else np.uint8
    )


def bayer_matrix(order: int) -> np.ndarray:
    """Recursive Bayer matrix of side 2**order, values 0..4**order-1."""
    m = np.array([[0]], dtype=np.int64)
    for _ in range(order):
        n = m.shape[0]
        m = np.block(
            [
                [4 * m + 0, 4 * m + 2],
                [4 * m + 3, 4 * m + 1],
            ]
        )
        assert m.shape[0] == 2 * n
    return m


def bayer_offsets(order: int = 4) -> np.ndarray:
    """Zero-mean dither offsets in units of one output LSB, shape (2^o, 2^o).

    offset = (bayer + 0.5)/4^o - 0.5  in (-0.5, 0.5), so adding the offset
    before round-to-nearest yields an unbiased ordered dither.
    """
    m = bayer_matrix(order).astype(np.float32)
    size = float(4**order)
    return ((m + 0.5) / size - 0.5).astype(np.float32)


def quantize_with_ordered_dither(x: np.ndarray, depth: int, dither: np.ndarray) -> np.ndarray:
    """Quantize float code values x (H, W) to integers at `depth` bits with a
    tiled ordered-dither offset (NumPy reference for the kernel's dither path)."""
    h, w = x.shape[-2], x.shape[-1]
    th, tw = dither.shape
    tiled = np.tile(dither, (h // th + 1, w // tw + 1))[:h, :w]
    maxv = (1 << depth) - 1
    return np.clip(np.floor(x + 0.5 + tiled), 0, maxv).astype(
        np.uint16 if depth > 8 else np.uint8
    )
