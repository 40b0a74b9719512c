"""NumPy reference of the whole YUV -> LUT -> YUV render pipeline.

A straight float32 NumPy composition of the colorcore pieces — range
normalization (matrices), YUV<->RGB (matrices), the LUT interpolators
(interp, xp=np) and the dither patterns (dither) — with the chroma
resampling and quantization rules written out plainly. It is independent of
the jitted device pipeline (ops.render) and is what that pipeline is
compared with, in the tests and on the device (chip_smoke.py).

The stage order follows the reference's FFmpeg filter chain
(src/lut_renderer/ffmpeg.py:195-247, 304-313): range -> chroma to 4:4:4 ->
RGB -> lut3d -> [scale] -> YUV -> chroma subsample -> quantize (+ dither).
"""

from __future__ import annotations

import numpy as np

from . import matrices
from .dither import bayer_offsets, hash_noise_offsets
from .interp import apply_lut

_F32 = np.float32


def _round_clip(x: np.ndarray, maxv: float) -> np.ndarray:
    return np.clip(np.floor(x + _F32(0.5)), 0, maxv)


def _chroma_to_444(c: np.ndarray, subsampling: str, mode: str) -> np.ndarray:
    if subsampling == "444":
        return c
    if subsampling == "422":
        return np.repeat(c, 2, axis=-1)
    up = np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1)
    if mode == "nearest":
        return up
    if mode != "bilinear":
        raise ValueError(f"unknown chroma upsample mode {mode!r}")
    pad = [(0, 0)] * (up.ndim - 2) + [(1, 1), (1, 1)]
    p = np.pad(up, pad, mode="edge")
    return (up * _F32(0.5)
            + _F32(0.125) * (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
                             + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]))


def _chroma_from_444(c: np.ndarray, subsampling: str) -> np.ndarray:
    if subsampling == "444":
        return c
    cols = c[..., :, 0::2] + c[..., :, 1::2]
    if subsampling == "422":
        return cols * _F32(0.5)
    return (cols[..., 0::2, :] + cols[..., 1::2, :]) * _F32(0.25)


def _quantize(x: np.ndarray, depth: int, dither: str,
              plane_seed: int) -> np.ndarray:
    h, w = x.shape[-2], x.shape[-1]
    if dither == "ordered":
        pat = bayer_offsets(4)
        th, tw = pat.shape
        x = x + np.tile(pat, (h // th + 1, w // tw + 1))[:h, :w]
    elif dither == "random":
        x = x + hash_noise_offsets(h, w, plane_seed)
    elif dither != "none":
        raise ValueError(f"the reference quantizes on the device only; "
                         f"dither {dither!r} is not a device dither")
    out = _round_clip(x, (1 << depth) - 1)
    return out.astype(np.uint8 if depth <= 8 else np.uint16)


def render_yuv_reference(y, u, v, cfg, lut=None, resize_weights=None):
    """Planar integer YUV at cfg.in_depth / cfg.in_subsampling in, planar
    integer YUV at cfg.out_depth / cfg.out_subsampling out.

    cfg: any object with the fields of ops.render.RenderConfig.
    lut: a Lut3D or PreparedLut (table + domain), or None for no LUT.
    resize_weights: the (Wv, Wh) matrices for cfg.resize (the swscale
    bicubic model, ops.resample.resample_weights); applied in float64.
    Leading batch axes are carried through."""
    yf, uf, vf = (np.asarray(a).astype(_F32) for a in (y, u, v))
    yf, uf, vf = matrices.range_normalize_yuv(
        yf, uf, vf, cfg.in_depth, cfg.in_full_range, cfg.work_full_range)
    yf, uf, vf = (np.asarray(a, _F32) for a in (yf, uf, vf))
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf, uf, vf = (_round_clip(a, maxv) for a in (yf, uf, vf))
    uf = _chroma_to_444(uf, cfg.in_subsampling, cfg.chroma_up)
    vf = _chroma_to_444(vf, cfg.in_subsampling, cfg.chroma_up)
    r, g, b = matrices.yuv_to_rgb_planes(
        yf, uf, vf, cfg.matrix_in, cfg.in_depth, cfg.work_full_range)
    if cfg.apply_lut and lut is not None:
        out = apply_lut(np.stack([r, g, b], axis=-1).astype(_F32), lut,
                        cfg.interp)
        r, g, b = out[..., 0], out[..., 1], out[..., 2]
    if cfg.resize is not None:
        if resize_weights is None:
            raise ValueError("cfg.resize needs resize_weights")
        wv, wh = (np.asarray(m, np.float64) for m in resize_weights)
        r, g, b = ((wv @ np.asarray(p, np.float64) @ wh.T).astype(_F32)
                   for p in (r, g, b))
    yo, uo, vo = matrices.rgb_to_yuv_planes(
        r, g, b, cfg.matrix_out, cfg.out_depth, cfg.out_full_range)
    uo = _chroma_from_444(np.asarray(uo, _F32), cfg.out_subsampling)
    vo = _chroma_from_444(np.asarray(vo, _F32), cfg.out_subsampling)
    return (_quantize(np.asarray(yo, _F32), cfg.out_depth, cfg.dither, 1),
            _quantize(uo, cfg.out_depth, cfg.dither, 2),
            _quantize(vo, cfg.out_depth, cfg.dither, 3))
