"""Geometry bucketing: serve ANY resolution from a precompiled program.

The reference renders whatever users drop in with zero warmup because
FFmpeg's filter chain is an interpreter — geometry-agnostic by construction
(reference src/lut_renderer/ffmpeg.py:189-193, 242-247: the lut3d chain
never mentions a resolution). XLA programs are shape-keyed instead, so a
geometry outside the warmed set pays a compile on its first batch.

Bucketing (LUT_TPU_GEOMETRY=bucket) rounds every ad hoc W x H *up* to a
small bucket ladder, edge-replicate-pad the planes on the HOST (numpy — no device
program depends on the ad hoc shape), run the bucket-shaped compiled
program, and crop the outputs back after readback. `serve --warmup`
precompiles the ladder, so a never-seen geometry's first batch runs at
warm speed.

Bit-exactness of the kept region (tests/test_geometry_bucket.py proves it
per config): every pipeline stage either is elementwise (range, matrix,
LUT), reads aligned non-overlapping windows (2x2 / 1x2 chroma box
downsamples — original dims are even, so kept outputs never straddle the
pad seam), clamps at edges exactly like replicate padding (bilinear chroma
upsample's edge pad), or anchors at the top-left corner (ordered/random
dither offsets — padding only ever extends bottom/right). Resize is the
one stage whose output depends on the input geometry globally, so resize
jobs keep exact-shape programs.

Bucket dims: widths are multiples of 128, heights multiples of 16; both
even for 4:2:0. The ladder is coarse on purpose — each bucket is one
compiled program, and ad hoc serving is host-(decode/encode)-bound anyway,
so padding waste costs little; production geometries (1080p/4K/8K) bypass
bucketing entirely and keep their exact-shape programs. Whether bucketing
pays on a given device is a measurement; the default runs exact shapes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# Landscape ladder + two portrait rungs (phone video). Sorted by area so
# pick_bucket's min() is deterministic on ties.
BUCKETS: Tuple[Tuple[int, int], ...] = (
    (640, 368),
    (1024, 576),
    (1280, 720),
    (1152, 1920),    # portrait 1080x1920 class
    (1920, 1088),
    (2560, 1440),
    (3840, 2176),
    (2176, 3840),    # portrait 4K class
    (4096, 2304),    # DCI 4K incl. scope crops (4096x1716 etc.)
    (7680, 4320),
)

# Exact-shape production programs (engine.warmup DEFAULT_PROGRAMS) — these
# bypass bucketing so the headline paths never pay pad/crop.
EXACT_GEOMETRIES = frozenset({(1920, 1080), (3840, 2160), (7680, 4320)})


def geometry_mode() -> str:
    """"bucket" (pad ad hoc geometries onto the ladder) when the env
    LUT_TPU_GEOMETRY says so, else "exact" (the default: every geometry
    compiles its own program; older settings' "auto" means the same).
    Surfaced in `doctor`."""
    mode = os.environ.get("LUT_TPU_GEOMETRY", "").lower()
    return "bucket" if mode == "bucket" else "exact"


def pick_bucket(w: int, h: int) -> Optional[Tuple[int, int]]:
    """The smallest-area bucket covering (w, h), or None when the geometry
    should run an exact-shape program: any geometry unless the mode is
    "bucket", production geometries, shapes that already ARE a bucket, and
    shapes beyond the ladder."""
    if geometry_mode() != "bucket":
        return None
    if (w, h) in EXACT_GEOMETRIES or (w, h) in BUCKETS:
        return None
    fits = [b for b in BUCKETS if b[0] >= w and b[1] >= h]
    if not fits:
        return None
    return min(fits, key=lambda b: b[0] * b[1])


def _chroma_dims(w: int, h: int, subsampling: str) -> Tuple[int, int]:
    if subsampling == "420":
        return w // 2, h // 2
    if subsampling == "422":
        return w // 2, h
    return w, h


def pad_batch_to_bucket(y, u, v, bucket: Tuple[int, int],
                        in_subsampling: str):
    """Edge-replicate-pad a stacked (B, H, W)/(B, Hc, Wc) plane batch to the
    bucket geometry. Host-side numpy ON PURPOSE: device-side padding would
    recreate a shape-keyed program per ad hoc geometry — the exact cost
    bucketing exists to kill."""
    bw, bh = bucket
    h, w = y.shape[-2], y.shape[-1]
    bcw, bch = _chroma_dims(bw, bh, in_subsampling)

    def _pad(a, th, tw):
        h, w = a.shape[-2], a.shape[-1]
        if th == h and tw == w:
            return np.ascontiguousarray(a)
        # manual fill instead of np.pad(mode="edge"): pad's generic path
        # is several times slower than the interior memcpy + two broadcast
        # edge fills below
        out = np.empty(a.shape[:-2] + (th, tw), a.dtype)
        out[..., :h, :w] = a
        if tw > w:
            out[..., :h, w:] = a[..., :, w - 1:w]
        if th > h:
            out[..., h:, :] = out[..., h - 1:h, :]
        return out

    if h > bh or w > bw:
        raise ValueError(f"frame {w}x{h} exceeds bucket {bw}x{bh}")
    return _pad(y, bh, bw), _pad(u, bch, bcw), _pad(v, bch, bcw)


def crop_batch_from_bucket(y, u, v, out_w: int, out_h: int,
                           out_subsampling: str):
    """Crop rendered bucket-shaped outputs back to the real geometry.
    Contiguous copies: the encoder FFI and the host error-diffusion pass
    both take dense planes."""
    cw, ch = _chroma_dims(out_w, out_h, out_subsampling)

    def _crop(a, th, tw):
        if a.shape[-2] == th and a.shape[-1] == tw:
            return a
        return np.ascontiguousarray(a[..., :th, :tw])

    return _crop(y, out_h, out_w), _crop(u, ch, cw), _crop(v, ch, cw)
