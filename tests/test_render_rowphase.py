"""Row-phase 420 layout: bit-exactness vs the plain full-res layout.

The row-phase path (ops/render._render_rowphase_420) re-orders the 420
pipeline into half-height phase space; whether that pays on the GPU is a
measurement still to make (ROADMAP Speed 4). It must be BIT-identical to the plain layout for every applicable config: the
same scalar ops run on the same values, dither offsets are phase-mapped.
Mirrors the reference's invariant that the filter graph output is layout
independent (lut3d operates per-pixel: FFmpeg vf_lut3d interp_* per-sample).
"""

import numpy as np
import pytest
from dataclasses import replace

from lut_renderer_tpu.colorcore import Lut3D
from lut_renderer_tpu.ops import prepare_lut
from lut_renderer_tpu.ops.pixel import hash_noise_offsets_jnp, quantize_plane
from lut_renderer_tpu.ops.render import (
    RenderConfig,
    _rowphase_applicable,
    render_yuv_frame,
)


@pytest.fixture(scope="module")
def prep():
    rng = np.random.default_rng(3)
    lut = Lut3D.identity(17)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.05, 0.05, lut.table.shape
                                ).astype(np.float32), 0, 1)
    return prepare_lut(lut)


def _planes(rng, b, h, w, depth):
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    y = rng.integers(0, hi + 1, (b, h, w)).astype(dt)
    u = rng.integers(0, hi + 1, (b, h // 2, w // 2)).astype(dt)
    v = rng.integers(0, hi + 1, (b, h // 2, w // 2)).astype(dt)
    return y, u, v


def _assert_layouts_equal(prep, cfg, b=2, h=48, w=64):
    rng = np.random.default_rng(7)
    y, u, v = _planes(rng, b, h, w, cfg.in_depth)
    got = render_yuv_frame(y, u, v, prep, cfg)
    want = render_yuv_frame(y, u, v, prep, replace(cfg, phase_layout="plain"))
    for name, a, e in zip("yuv", got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(e),
                                      err_msg=f"plane {name} cfg={cfg}")


@pytest.mark.parametrize("dither", ["none", "ordered", "random"])
def test_rowphase_bit_exact_dithers(prep, dither):
    _assert_layouts_equal(prep, RenderConfig(dither=dither))


@pytest.mark.parametrize("interp", ["trilinear", "tetrahedral"])
def test_rowphase_bit_exact_interps(prep, interp):
    _assert_layouts_equal(
        prep, RenderConfig(interp=interp))


def test_rowphase_bit_exact_10bit_full_range(prep):
    _assert_layouts_equal(prep, RenderConfig(
        in_depth=10, out_depth=10, in_full_range=True,
        work_full_range=False, out_full_range=False, dither="ordered"))


def test_rowphase_bit_exact_depth_change(prep):
    _assert_layouts_equal(prep, RenderConfig(
        in_depth=10, out_depth=8, dither="ordered"))


def test_rowphase_bit_exact_no_lut(prep):
    rng = np.random.default_rng(9)
    y, u, v = _planes(rng, 1, 32, 48, 8)
    cfg = RenderConfig(apply_lut=False)
    got = render_yuv_frame(y, u, v, None, cfg)
    want = render_yuv_frame(y, u, v, None,
                            replace(cfg, phase_layout="plain"))
    for a, e in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(e))


def test_rowphase_gate():
    rng = np.random.default_rng(1)
    y, u, _ = _planes(rng, 1, 32, 48, 8)
    assert _rowphase_applicable(y, u, RenderConfig())
    # every plain-only config falls back
    for cfg in (
        RenderConfig(in_subsampling="422"),
        RenderConfig(out_subsampling="444"),
        RenderConfig(chroma_up="bilinear"),
        RenderConfig(resize=(24, 16)),
        RenderConfig(dither="error_diffusion_host"),
        RenderConfig(phase_layout="plain"),
    ):
        assert not _rowphase_applicable(y, u, cfg)
    # odd geometry (y not exactly 2x chroma) stays plain
    assert not _rowphase_applicable(y[:, :31, :], u, RenderConfig())


@pytest.mark.parametrize("dither", ["ordered", "random"])
def test_quantize_row_mapped_dither_matches_slices(dither):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (2, 32, 48)).astype(np.float32)
    full = np.asarray(quantize_plane(x, 8, dither, plane_seed=1))
    for p in (0, 1):
        part = np.asarray(quantize_plane(x[:, p::2, :], 8, dither,
                                         plane_seed=1, row_stride=2,
                                         row_offset=p))
        np.testing.assert_array_equal(part, full[:, p::2, :])


def test_hash_offsets_row_mapped():
    full = np.asarray(hash_noise_offsets_jnp(32, 16, plane_seed=2))
    for p in (0, 1):
        part = np.asarray(hash_noise_offsets_jnp(16, 16, plane_seed=2,
                                                 row_stride=2, row_offset=p))
        np.testing.assert_array_equal(part, full[p::2, :])


def test_quantize_row_stride_rejects_tile_offset():
    x = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError):
        quantize_plane(x, 8, "ordered", tile_offset=(1, 0), row_stride=2)


def test_rowphase_fuzz_random_configs(prep):
    """Seeded sweep over the config space: any applicable config must be
    bit-identical between layouts; non-applicable ones must hit the plain
    path (trivially equal). Broader than the targeted cases above."""
    rng = np.random.default_rng(2024)
    for _ in range(12):
        in_depth = int(rng.choice([8, 10, 12]))
        out_depth = int(rng.choice([8, 10]))
        cfg = RenderConfig(
            in_depth=in_depth,
            out_depth=out_depth,
            in_full_range=bool(rng.integers(2)),
            work_full_range=bool(rng.integers(2)),
            out_full_range=bool(rng.integers(2)),
            matrix_in=str(rng.choice(["bt709", "bt601", "bt2020"])),
            matrix_out=str(rng.choice(["bt709", "bt601"])),
            interp=str(rng.choice(["trilinear", "tetrahedral"])),
            dither=str(rng.choice(["none", "ordered", "random"])),
            requantize_intermediate=bool(rng.integers(2)),
        )
        _assert_layouts_equal(prep, cfg, b=1, h=32, w=48)


def test_phase_layout_validated():
    rng = np.random.default_rng(1)
    y, u, v = _planes(rng, 1, 16, 16, 8)
    with pytest.raises(ValueError):
        render_yuv_frame(y, u, v, None,
                         RenderConfig(apply_lut=False, phase_layout="Auto"))
