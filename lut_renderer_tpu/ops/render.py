"""Fused per-frame render op: planar YUV in -> planar YUV out on the device.

Assembles the full pixel pipeline the reference expresses as an FFmpeg filter
chain (scale range/matrix -> format -> lut3d -> [dither] -> format, assembled
at src/lut_renderer/ffmpeg.py:195-247,304-310 and executed inside the FFmpeg
process): here it is one jit-compiled function — XLA fuses the elementwise
stages around the LUT core's gathers (ops.lut3d).

The whole function is vmappable over a leading frame-batch axis and shardable
over a device mesh (parallel.sharding wires that up).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .lut3d import apply_lut_planes
from .pixel import (
    chroma_downsample_420,
    chroma_downsample_422,
    chroma_resample_422_to_444,
    chroma_upsample_420,
    quantize_plane,
    range_normalize,
    yuv_planes_to_rgb,
    rgb_to_yuv_planes,
)
from .prepare import PreparedLut
from .resample import resample_plane, resample_weights


@dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) pixel-pipeline configuration for one render stage.

    Derived from a plan.RenderSpec + probe info by engine.executor; kept
    independent here so the op layer has no upward dependencies.
    """

    in_depth: int = 8
    out_depth: int = 8
    in_subsampling: str = "420"   # "420" | "422" | "444"
    out_subsampling: str = "420"
    in_full_range: bool = False
    # Range the pipeline normalizes to before the LUT (policy: pc sources ->
    # tv unless tags say otherwise; ffmpeg.py:212-233).
    work_full_range: bool = False
    out_full_range: bool = False
    matrix_in: str = "bt709"
    matrix_out: str = "bt709"
    interp: str = "tetrahedral"
    dither: str = "none"          # "none" | "ordered"
    chroma_up: str = "nearest"    # "nearest" | "bilinear"
    apply_lut: bool = True
    # Requantize after range normalization to mimic the reference's 8-bit
    # intermediate `format=yuv420p` step (ffmpeg.py:233); parity knob.
    requantize_intermediate: bool = True
    # Output resolution (w, h) when the policy carries `-s WxH`
    # (ffmpeg.py:312-313); None keeps source size. swscale-matched bicubic
    # (SWS_BICUBIC B=0 C=0.6 — FFmpeg's `-s` default scaler) on the RGB
    # planes after the LUT, applied as matmuls (ops.resample).
    resize: Optional[Tuple[int, int]] = None
    # Pixel-pipeline layout. "auto" takes "rowphase" where it applies
    # (420 -> 420 nearest, no resize) and "plain" elsewhere:
    #   "rowphase" — the row-phase half-height layout, bit-identical to
    #      plain (tests/test_render_rowphase.py);
    #   "plain"    — the straight full-res layout.
    # Each name also forces that layout (for tests and measurement).
    phase_layout: str = "auto"


def _upsample(u, v, subsampling: str, mode: str):
    if subsampling == "420":
        return chroma_upsample_420(u, mode), chroma_upsample_420(v, mode)
    if subsampling == "422":
        return chroma_resample_422_to_444(u), chroma_resample_422_to_444(v)
    return u, v


def _downsample(u, v, subsampling: str):
    if subsampling == "420":
        return chroma_downsample_420(u), chroma_downsample_420(v)
    if subsampling == "422":
        return chroma_downsample_422(u), chroma_downsample_422(v)
    return u, v


_PHASE_LAYOUTS = ("auto", "plain", "rowphase")


def _rowphase_applicable(y, u, cfg: RenderConfig) -> bool:
    """True when the frame can take the row-phase 420 layout: 420 in and out
    with nearest chroma siting, no resize, and geometry that factors exactly
    (full-res H, W = 2x the chroma plane). Error-diffusion output is float
    full-res planes, so that path stays plain too."""
    if cfg.phase_layout not in _PHASE_LAYOUTS:
        raise ValueError(f"unknown phase_layout {cfg.phase_layout!r}")
    return (
        cfg.phase_layout in ("auto", "rowphase")
        and cfg.in_subsampling == "420"
        and cfg.out_subsampling == "420"
        and cfg.chroma_up == "nearest"
        and cfg.resize is None
        and cfg.dither != "error_diffusion_host"
        and y.ndim >= 2
        and y.shape[-2] == 2 * u.shape[-2]
        and y.shape[-1] == 2 * u.shape[-1]
    )


def _render_rowphase_420(y, u, v, prep, cfg, lut_table):
    """Row-phase twin of the plain pipeline for 420->420 nearest: y splits
    into two half-height row phases (row-strided reads), both pair
    elementwise with a single column-doubled chroma plane (== exact nearest
    upsample), the 2x2 box downsample becomes column adds per phase + a
    phase add in the plain path's grouping, and only the final quantized y
    pays one row interleave (stack(-2)+reshape). Bit-identical to the plain
    path per-pixel: same scalar ops on the same values, dither offsets
    phase-mapped (quantize_plane row_stride/row_offset)."""
    yp = jnp.stack([y[..., 0::2, :], y[..., 1::2, :]], axis=-3)
    ud = jnp.repeat(u, 2, axis=-1)[..., None, :, :]
    vd = jnp.repeat(v, 2, axis=-1)[..., None, :, :]

    yf = yp.astype(jnp.float32)
    uf = ud.astype(jnp.float32)
    vf = vd.astype(jnp.float32)
    yf, uf, vf = range_normalize(
        yf, uf, vf, cfg.in_depth, cfg.in_full_range, cfg.work_full_range
    )
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf = jnp.clip(jnp.floor(yf + 0.5), 0, maxv)
        uf = jnp.clip(jnp.floor(uf + 0.5), 0, maxv)
        vf = jnp.clip(jnp.floor(vf + 0.5), 0, maxv)

    # every output of yuv_planes_to_rgb contains the luma term, so r/g/b
    # are already broadcast to the full (.., 2, Hc, W) phase shape
    r, g, b = yuv_planes_to_rgb(
        yf, uf, vf, cfg.matrix_in, cfg.in_depth, cfg.work_full_range
    )
    if cfg.apply_lut and prep is not None:
        r, g, b = apply_lut_planes(r, g, b, prep, cfg.interp,
                                   table=lut_table)
    yo, uo, vo = rgb_to_yuv_planes(
        r, g, b, cfg.matrix_out, cfg.out_depth, cfg.out_full_range
    )

    # 2x2 box downsample == column adds per phase, then the phase add — the
    # exact add grouping of chroma_downsample_420 on the full-res plane.
    def _down(c):
        a = c[..., :, 0::2] + c[..., :, 1::2]
        return (a[..., 0, :, :] + a[..., 1, :, :]) * 0.25

    uo, vo = _down(uo), _down(vo)

    def _ilv(e, o):
        hc, w = e.shape[-2], e.shape[-1]
        return jnp.stack([e, o], axis=-2).reshape(e.shape[:-2] + (2 * hc, w))

    ye, yod = yo[..., 0, :, :], yo[..., 1, :, :]
    yq_e = quantize_plane(ye, cfg.out_depth, cfg.dither, plane_seed=1,
                          row_stride=2, row_offset=0)
    yq_o = quantize_plane(yod, cfg.out_depth, cfg.dither, plane_seed=1,
                          row_stride=2, row_offset=1)
    uq = quantize_plane(uo, cfg.out_depth, cfg.dither, plane_seed=2)
    vq = quantize_plane(vo, cfg.out_depth, cfg.dither, plane_seed=3)
    return _ilv(yq_e, yq_o), uq, vq


def render_yuv_frame(
    y, u, v,
    prep: Optional[PreparedLut],
    cfg: RenderConfig,
    lut_table=None,
    resize_weights=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One frame through the fused pipeline. Inputs are integer code-value
    planes (uint8/uint16) at cfg.in_depth with cfg.in_subsampling chroma.
    lut_table: optional device copy of prep.table passed as a jit argument
    so the jitted program stays LUT-agnostic — see make_render_fn.
    resize_weights: optional (Wv, Wh) pair for cfg.resize passed as jit
    arguments (make_render_fn); when None they trace as constants."""
    if _rowphase_applicable(y, u, cfg):
        return _render_rowphase_420(y, u, v, prep, cfg, lut_table)
    yf = y.astype(jnp.float32)
    uf = u.astype(jnp.float32)
    vf = v.astype(jnp.float32)

    # 1. range normalization in YUV space (pc -> work range), matching the
    #    reference's scale=in_range:out_range step placement before the LUT.
    yf, uf, vf = range_normalize(
        yf, uf, vf, cfg.in_depth, cfg.in_full_range, cfg.work_full_range
    )
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf = jnp.clip(jnp.floor(yf + 0.5), 0, maxv)
        uf = jnp.clip(jnp.floor(uf + 0.5), 0, maxv)
        vf = jnp.clip(jnp.floor(vf + 0.5), 0, maxv)

    # 2. chroma to 4:4:4
    uf, vf = _upsample(uf, vf, cfg.in_subsampling, cfg.chroma_up)

    # 3. YUV -> RGB [0,1]
    r, g, b = yuv_planes_to_rgb(
        yf, uf, vf, cfg.matrix_in, cfg.in_depth, cfg.work_full_range
    )

    # 4. 3D LUT
    if cfg.apply_lut and prep is not None:
        r, g, b = apply_lut_planes(r, g, b, prep, cfg.interp,
                                   table=lut_table)

    # 4b. optional resolution change (policy `-s`): swscale-matched bicubic
    # as two matmuls per plane (ops.resample; parity-tested against the
    # bundled libswscale in tests/test_resample.py)
    if cfg.resize is not None:
        rw, rh = cfg.resize
        wv, wh = (resize_weights if resize_weights is not None
                  else resample_weights(r.shape[-2:], (rh, rw)))
        r = resample_plane(r, wv, wh)
        g = resample_plane(g, wv, wh)
        b = resample_plane(b, wv, wh)

    # 5. RGB -> YUV at output depth/range/matrix
    yo, uo, vo = rgb_to_yuv_planes(
        r, g, b, cfg.matrix_out, cfg.out_depth, cfg.out_full_range
    )

    # 6. chroma subsample (on float values, pre-quantization)
    uo, vo = _downsample(uo, vo, cfg.out_subsampling)

    # 7. quantize (+ ordered dither if requested). "error_diffusion_host"
    # defers quantization: float planes return to the host where the native
    # Floyd-Steinberg pass (serial, CPU) finishes the job — see
    # engine.executor and native_ext.error_diffusion_quantize.
    if cfg.dither == "error_diffusion_host":
        return yo, uo, vo
    # distinct plane seeds decorrelate the "random" dither across Y/U/V
    yq = quantize_plane(yo, cfg.out_depth, cfg.dither, plane_seed=1)
    uq = quantize_plane(uo, cfg.out_depth, cfg.dither, plane_seed=2)
    vq = quantize_plane(vo, cfg.out_depth, cfg.dither, plane_seed=3)
    return yq, uq, vq


def prep_static_key(prep: Optional[PreparedLut], cfg: RenderConfig):
    """Everything about a PreparedLut that a traced render program depends
    on BESIDES the table values (which ride as a runtime operand): the size
    and the domain mapping (baked as scalars). Two LUTs agreeing on this key
    share one jitted function and one compiled program."""
    if prep is None or not cfg.apply_lut:
        return None
    return (
        prep.size,
        tuple(float(v) for v in prep.domain_min),
        tuple(float(v) for v in prep.domain_max),
    )


# jitted render fns keyed by (cfg, prep_static_key): a new LUT of an
# already-seen size and domain reuses the jitted fn outright — no retrace, no
# compile, only a device_put of its table (the serving fast path).
# Bounded FIFO: each entry's closure pins one PreparedLut (25 MB at
# 129^3), so a long-lived daemon over many size/cfg combos must not
# grow without limit; evicted fns fall back to the persistent XLA cache.
_RENDER_FN_CACHE: dict = {}
_RENDER_FN_CACHE_MAX = 32
# concurrent TaskRunners (daemon concurrency > 1) and parallel warmup
# threads all reach this cache; the FIFO eviction loop is not atomic
import threading as _threading

_RENDER_FN_CACHE_LOCK = _threading.Lock()


def make_render_fn(prep: Optional[PreparedLut], cfg: RenderConfig):
    """Build a jitted render function.

    The pipeline is batch-polymorphic by construction (all planar ops work on
    trailing (H, W) axes and the LUT core works on any leading shape), so
    batched (B, H, W) / (B, Hc, Wc) inputs flow through the SAME code path
    as single frames.

    The LUT table rides as a jit ARGUMENT (device_put once here), not as a
    baked constant, so the compiled program depends only on shapes, LUT
    size, interp, and domain — not the table values — and the jitted
    function itself is cached across LUTs (prep_static_key)."""
    table_np = prep.table if prep is not None and cfg.apply_lut else None
    if table_np is None and cfg.resize is None:
        fn = functools.partial(render_yuv_frame, prep=prep, cfg=cfg)
        return jax.jit(lambda y, u, v: fn(y, u, v))
    key = (cfg, prep_static_key(prep, cfg))
    with _RENDER_FN_CACHE_LOCK:
        jitted = _RENDER_FN_CACHE.get(key)
        if jitted is None:
            fn = functools.partial(render_yuv_frame, prep=prep, cfg=cfg)
            jitted = jax.jit(
                lambda y, u, v, table, rsw: fn(y, u, v, lut_table=table,
                                               resize_weights=rsw))
            while len(_RENDER_FN_CACHE) >= _RENDER_FN_CACHE_MAX:
                _RENDER_FN_CACHE.pop(next(iter(_RENDER_FN_CACHE)))
            _RENDER_FN_CACHE[key] = jitted
    table_dev = None if table_np is None else jax.device_put(table_np)
    if cfg.resize is None:
        return lambda y, u, v: jitted(y, u, v, table_dev, None)

    # Resize weight matrices depend on the INPUT luma shape (known only at
    # call time); ride as jit args — device_put once per shape — so resize
    # programs stay free of multi-MB weight constants (118 MB at 8K).
    rsw_cache: dict = {}

    def call(y, u, v):
        hw = (int(y.shape[-2]), int(y.shape[-1]))
        rsw = rsw_cache.get(hw)
        if rsw is None:
            rw, rh = cfg.resize
            rsw = jax.device_put(resample_weights(hw, (rh, rw)))
            rsw_cache[hw] = rsw
        return jitted(y, u, v, table_dev, rsw)

    return call
