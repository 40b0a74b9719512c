"""ops — the device side of the fused pixel pipeline.

The hot op replaces FFmpeg's `lut3d` filter (the reference's per-frame pixel
engine, invoked via src/lut_renderer/ffmpeg.py:179-414): the reference
interpolators run as XLA gathers (ops.lut3d) inside one jitted YUV -> YUV
step (ops.render). All pixel data is planar.

Exports resolve LAZILY (PEP 562): importing this package does NOT import
jax, so pure-NumPy paths (`from lut_renderer_tpu.ops.prepare import
prepare_lut`, .cube parsing) stay cheap for tools that never render.
"""

import importlib

_LAZY = {
    "PreparedLut": ".prepare",
    "prepare_lut": ".prepare",
    "apply_lut_planes": ".lut3d",
    "chroma_downsample_420": ".pixel",
    "chroma_upsample_420": ".pixel",
    "quantize_plane": ".pixel",
    "yuv_planes_to_rgb": ".pixel",
    "rgb_to_yuv_planes": ".pixel",
    "RenderConfig": ".render",
    "render_yuv_frame": ".render",
    "make_render_fn": ".render",
    "swscale_bicubic_weights": ".resample",
    "resample_weights": ".resample",
    "resample_plane": ".resample",
}

__all__ = list(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(target, __name__), name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
