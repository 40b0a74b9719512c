"""Parity of ops.resample with FFmpeg's own `-s` scaler (swscale SWS_BICUBIC).

The reference forwards params.resolution as `-s WxH` (ffmpeg.py:312-313),
which FFmpeg executes with its default bicubic (B=0, C=0.6) scaler. These
tests drive the bundled libswscale through hostio.oracle.ScaleOracle and
check our closed-form weight model and the jnp matmul apply against it —
including phase conventions, downscale anti-alias widening, and border
folding, which were reverse-engineered by impulse extraction
(experiments/r4_scale_probe.py).
"""

import numpy as np
import pytest

from lut_renderer_tpu.hostio.oracle import ScaleOracle
from lut_renderer_tpu.ops.resample import (
    resample_plane,
    resample_weights,
    swscale_bicubic_weights,
)


def _oracle_matrix(src: int, dst: int) -> np.ndarray:
    """Extract swscale's actual (dst, src) horizontal weight matrix by
    impulse responses on a 0.25 background (reveals negative lobes; the f32
    output path clamps to [0,1])."""
    with ScaleOracle(src, 4, dst, 4) as orc:
        W = np.zeros((dst, src), np.float64)
        for j in range(src):
            plane = np.full((4, src), 0.25, np.float32)
            plane[:, j] += 0.25
            W[:, j] = (orc.scale_gray(plane)[2].astype(np.float64) - 0.25) / 0.25
    return W


@pytest.mark.parametrize(
    "src,dst",
    [
        (16, 32),   # x2 upscale (exact phase)
        (32, 16),   # x2 downscale (anti-alias widening)
        (24, 10),   # non-integer downscale (xInc rounding)
        (10, 24),   # non-integer upscale
        (17, 13),   # odd/odd
        (12, 12),   # identity ratio
    ],
)
def test_weights_match_swscale(src, dst):
    ours = swscale_bicubic_weights(src, dst).astype(np.float64)
    theirs = _oracle_matrix(src, dst)
    # oracle extraction noise: 14-bit coefficient quantization + background
    # subtraction at amplitude 0.25 -> ~5e-4; allow 2e-3
    np.testing.assert_allclose(ours, theirs, atol=2e-3)


def test_identity_ratio_is_identity():
    W = swscale_bicubic_weights(64, 64)
    np.testing.assert_allclose(W, np.eye(64, dtype=np.float32), atol=1e-7)


def test_rows_normalized():
    for src, dst in [(33, 77), (77, 33), (1920, 1280), (720, 1080)]:
        W = swscale_bicubic_weights(src, dst)
        np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-5)


def _smooth_plane(h, w, seed=0):
    """Low-frequency test content in [0.3, 0.7]: bicubic overshoot stays
    inside [0,1] so swscale's f32 output clamp can't skew the comparison."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    p = (
        0.5
        + 0.12 * np.sin(2 * np.pi * xx / w * 2.3 + rng.uniform(0, 6))
        + 0.08 * np.cos(2 * np.pi * yy / h * 1.7 + rng.uniform(0, 6))
    )
    return p.astype(np.float32)


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((32, 48), (16, 24)), ((24, 20), (36, 52)), ((30, 44), (44, 30))],
)
def test_plane_resample_matches_swscale(in_hw, out_hw):
    (ih, iw), (oh, ow) = in_hw, out_hw
    plane = _smooth_plane(ih, iw)
    with ScaleOracle(iw, ih, ow, oh) as orc:
        ref = orc.scale_gray(plane)
    wv, wh = resample_weights((ih, iw), (oh, ow))
    ours = np.asarray(resample_plane(plane, wv, wh))
    np.testing.assert_allclose(np.clip(ours, 0.0, 1.0), ref, atol=2e-3)


def test_resample_batched_shapes():
    wv, wh = resample_weights((20, 24), (10, 12))
    x = np.random.default_rng(1).random((3, 20, 24), np.float32)
    out = np.asarray(resample_plane(x, wv, wh))
    assert out.shape == (3, 10, 12)
    single = np.asarray(resample_plane(x[1], wv, wh))
    np.testing.assert_allclose(out[1], single, rtol=1e-6, atol=1e-6)


def test_render_resize_uses_swscale_model(tmp_path):
    """The fused render path with cfg.resize produces the same planes as
    resampling its unresized RGB output explicitly (constants path), and
    make_render_fn's operand path agrees with the constants path."""
    import jax.numpy as jnp

    from lut_renderer_tpu.ops.render import (
        RenderConfig,
        make_render_fn,
        render_yuv_frame,
    )

    rng = np.random.default_rng(7)
    h, w = 24, 32
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)

    cfg = RenderConfig(resize=(16, 12), apply_lut=False)
    ya, ua, va = render_yuv_frame(jnp.asarray(y), jnp.asarray(u),
                                  jnp.asarray(v), None, cfg)
    assert ya.shape == (12, 16) and ua.shape == (6, 8)

    fn = make_render_fn(None, cfg)
    yb, ub, vb = fn(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(ub))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
