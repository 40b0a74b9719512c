"""3D-LUT application on the device: the reference interpolators as XLA gathers.

Replaces FFmpeg's `lut3d` filter (the reference's pixel engine, argv-injected
at src/lut_renderer/ffmpeg.py:242-247). The interpolation is
colorcore.interp run with `xp=jax.numpy`, so the device path and the NumPy
oracle share one implementation of FFmpeg's semantics; XLA lowers the corner
lookups to native gathers on the GPU.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..colorcore import interp as cinterp
from .prepare import PreparedLut


def apply_lut_planes(
    r: jnp.ndarray,
    g: jnp.ndarray,
    b: jnp.ndarray,
    prep: PreparedLut,
    interp: str = "tetrahedral",
    table=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Apply a prepared 3D LUT to planar float RGB in [0,1].

    r/g/b: same-shaped float arrays (typically (H, W) or (B, H, W)).
    table: optional (N, N, N, 3) device array standing in for prep.table.
    Pass it as a jit ARGUMENT to keep compiled programs LUT-agnostic; None
    bakes prep.table into the program as a constant. Unknown interp names
    fall back to tetrahedral, like the reference (ffmpeg.py:243-244).
    """
    fn = cinterp._FUNCS.get(interp, cinterp.apply_lut_tetrahedral)
    table = jnp.asarray(prep.table if table is None else table)
    rgb = jnp.stack([r, g, b], axis=-1)
    out = fn(rgb, table, prep.domain_min, prep.domain_max, xp=jnp)
    return out[..., 0], out[..., 1], out[..., 2]
