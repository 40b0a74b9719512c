"""END-TO-END parity: the reference's complete FFmpeg filter chain vs the
fused device render, yuv420p in -> yuv420p out.

The kernel-level oracle (tests/test_oracle_parity.py) isolates lut3d on RGB
planes; this suite instead runs the chain the reference actually emits
(src/lut_renderer/ffmpeg.py:195-247: scale range/matrix tagging -> [format]
-> lut3d -> format back to the encoder pix_fmt) through the bundled
libavfilter — auto-inserted format negotiation and all — and compares the
full pipelines at the output code-value level. This pins everything the
reference delegates to FFmpeg: matrix selection via frame tagging, chroma
siting, range normalization placement, and quantization.

Empirical calibration (experiments/r4_chain_parity.py): with the bt709 tag
the pipelines agree to max|d|<=3 on luma and <=2 on chroma; routing FFmpeg
through a 16-bit RGB intermediate collapses luma to max|d|<=2 with
frac(|d|>1) ~ 1e-4, proving the residual is FFmpeg's own 8-bit RGB
intermediate quantization (we keep f32 end-to-end — strictly tighter), not a
math mismatch.
"""

import numpy as np
import pytest

from lut_renderer_tpu.colorcore.cube import Lut3D, parse_cube_file, write_cube_file
from lut_renderer_tpu.hostio.oracle import ChainOracle
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.ops.render import RenderConfig, render_yuv_frame

H, W = 72, 96


def _smooth_planes(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = 16 + 200 * (0.5 + 0.4 * np.sin(xx / w * 5 + rng.uniform(0, 6))
                    * np.cos(yy / h * 4))
    u = 128 + 90 * np.sin(xx / w * 3)[0:h:2, 0:w:2]
    v = 128 + 90 * np.cos(yy / h * 2)[0:h:2, 0:w:2]
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def lut_path(tmp_path_factory):
    n = 17
    ax = np.linspace(0, 1, n, dtype=np.float64)
    r, g, b = np.meshgrid(ax, ax, ax, indexing="ij")
    tbl = np.stack(
        [np.clip(r ** 0.92 * 1.05, 0, 1),
         np.clip(g * 0.97 + 0.01, 0, 1),
         np.clip(b ** 1.06 * 0.95 + 0.02, 0, 1)],
        axis=-1).astype(np.float32)
    path = tmp_path_factory.mktemp("chain") / "grade.cube"
    write_cube_file(path, Lut3D(table=tbl))
    return str(path)


def _escape(p: str) -> str:
    return p.replace("\\", "\\\\").replace("'", "\\'")


def _ours(y, u, v, prep, cfg):
    import jax.numpy as jnp

    oy, ou, ov = render_yuv_frame(jnp.asarray(y), jnp.asarray(u),
                                  jnp.asarray(v), prep, cfg)
    return np.asarray(oy), np.asarray(ou), np.asarray(ov)


def _assert_close(ffm, ours, max_y, max_c, mean_y):
    for name, a, b, lim in (("y", ffm[0], ours[0], max_y),
                            ("u", ffm[1], ours[1], max_c),
                            ("v", ffm[2], ours[2], max_c)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= lim, f"{name}: max|d|={d.max()} > {lim}"
    dy = np.abs(ffm[0].astype(np.int32) - ours[0].astype(np.int32))
    assert dy.mean() <= mean_y, f"y mean|d|={dy.mean():.3f} > {mean_y}"


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
def test_full_chain_bt709_tagged(lut_path, interp):
    """The production case: scale tags bt709, lut3d converts via the tag."""
    y, u, v = _smooth_planes()
    prep = prepare_lut(parse_cube_file(lut_path))
    filters = [
        ("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
        ("lut3d", f"file='{_escape(lut_path)}':interp={interp}"),
        ("format", "pix_fmts=yuv420p"),
    ]
    with ChainOracle(W, H, filters) as orc:
        ffm = orc.apply_yuv(y, u, v)
    cfg = RenderConfig(interp=interp, phase_layout="plain")
    _assert_close(ffm, _ours(y, u, v, prep, cfg), max_y=3, max_c=2, mean_y=1.8)


def test_full_chain_untagged_uses_bt601(lut_path):
    """Without the scale tag, FFmpeg's auto-inserted conversion falls back to
    bt601 — exactly the matrix our policy models for untagged sources."""
    y, u, v = _smooth_planes(seed=1)
    prep = prepare_lut(parse_cube_file(lut_path))
    filters = [
        ("lut3d", f"file='{_escape(lut_path)}':interp=tetrahedral"),
        ("format", "pix_fmts=yuv420p"),
    ]
    with ChainOracle(W, H, filters) as orc:
        ffm = orc.apply_yuv(y, u, v)
    cfg601 = RenderConfig(interp="tetrahedral", matrix_in="bt601",
                          matrix_out="bt601", phase_layout="plain")
    _assert_close(ffm, _ours(y, u, v, prep, cfg601),
                  max_y=3, max_c=2, mean_y=1.8)
    # and bt709 does NOT match — the tag test above isn't vacuous
    cfg709 = RenderConfig(interp="tetrahedral", phase_layout="plain")
    oy = _ours(y, u, v, prep, cfg709)[0]
    assert np.abs(ffm[0].astype(np.int32) - oy.astype(np.int32)).max() > 5


def test_residual_is_ffmpeg_8bit_intermediate(lut_path):
    """Forcing FFmpeg through a 16-bit RGB intermediate collapses the luma
    diff to frac(|d|>1) ~ 1e-4: the tagged-chain residual above is FFmpeg's
    own 8-bit RGB quantization (we stay f32), not a pipeline mismatch."""
    y, u, v = _smooth_planes()
    prep = prepare_lut(parse_cube_file(lut_path))
    filters = [
        ("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
        ("format", "pix_fmts=gbrp16le"),
        ("lut3d", f"file='{_escape(lut_path)}':interp=tetrahedral"),
        ("format", "pix_fmts=yuv420p"),
    ]
    with ChainOracle(W, H, filters) as orc:
        ffm = orc.apply_yuv(y, u, v)
    cfg = RenderConfig(interp="tetrahedral", phase_layout="plain")
    ours = _ours(y, u, v, prep, cfg)
    dy = np.abs(ffm[0].astype(np.int32) - ours[0].astype(np.int32))
    assert dy.max() <= 2
    assert (dy > 1).mean() <= 1e-3


def test_full_chain_fullrange_normalization(lut_path):
    """yuvj/full-range source: the reference emits scale=in_range=pc:
    out_range=tv + format before lut3d (ffmpeg.py:211-233); our
    in_full_range+requantize_intermediate path matches it end to end."""
    y, u, v = _smooth_planes(seed=2)
    prep = prepare_lut(parse_cube_file(lut_path))
    filters = [
        ("scale", "in_range=pc:out_range=tv:in_color_matrix=bt709:"
                  "out_color_matrix=bt709"),
        ("format", "pix_fmts=yuv420p"),
        ("lut3d", f"file='{_escape(lut_path)}':interp=tetrahedral"),
        ("format", "pix_fmts=yuv420p"),
    ]
    with ChainOracle(W, H, filters) as orc:
        ffm = orc.apply_yuv(y, u, v)
    cfg = RenderConfig(interp="tetrahedral", phase_layout="plain",
                       in_full_range=True, work_full_range=False,
                       requantize_intermediate=True)
    _assert_close(ffm, _ours(y, u, v, prep, cfg), max_y=3, max_c=2, mean_y=1.8)


def test_full_chain_10bit(lut_path):
    """10-bit end to end: yuv420p10le through the tagged chain vs our
    in_depth=out_depth=10 render. FFmpeg negotiates a >=10-bit RGB
    intermediate here, so agreement is tighter relative to scale."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    y = 64 + 800 * (0.5 + 0.4 * np.sin(xx / W * 5) * np.cos(yy / H * 4))
    u = 512 + 360 * np.sin(xx / W * 3)[0:H:2, 0:W:2]
    v = 512 + 360 * np.cos(yy / H * 2)[0:H:2, 0:W:2]
    y = np.clip(y + rng.normal(0, 2, y.shape), 0, 1023).astype(np.uint16)
    u = np.clip(u, 0, 1023).astype(np.uint16)
    v = np.clip(v, 0, 1023).astype(np.uint16)
    prep = prepare_lut(parse_cube_file(lut_path))
    filters = [
        ("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
        ("lut3d", f"file='{_escape(lut_path)}':interp=tetrahedral"),
        ("format", "pix_fmts=yuv420p10le"),
    ]
    with ChainOracle(W, H, filters, pix_fmt="yuv420p10le") as orc:
        ffm = orc.apply_yuv(y, u, v)
    cfg = RenderConfig(interp="tetrahedral", phase_layout="plain",
                       in_depth=10, out_depth=10)
    ours = _ours(y, u, v, prep, cfg)
    # 10-bit units: FFmpeg's >=10-bit RGB intermediate keeps |d| small
    _assert_close(ffm, ours, max_y=6, max_c=4, mean_y=2.0)
