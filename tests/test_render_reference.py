"""The jitted render step (ops.render) against the NumPy pipeline reference
(colorcore.pipeline) over the config grid: depths, ranges, dithers,
subsampling geometries, interps, matrices, layouts, LUT sizes and resize.

Both compute in float32 from the same formulas, so on the CPU they agree
exactly at these sizes. The bound asserted is the one the device run
(chip_smoke.py) holds: at most 1 output code value, on fewer than 1e-3 of
the samples — what fused multiply-adds may flip at rounding boundaries.
"""

from dataclasses import replace

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import Lut3D
from lut_renderer_tpu.colorcore.pipeline import render_yuv_reference
from lut_renderer_tpu.ops import RenderConfig, prepare_lut
from lut_renderer_tpu.ops.render import make_render_fn, render_yuv_frame
from lut_renderer_tpu.ops.resample import resample_weights


def _lut(n, seed=3):
    rng = np.random.default_rng(seed + n)
    lut = Lut3D.identity(n)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.05, 0.05, lut.table.shape
                                ).astype(np.float32), 0, 1)
    return lut


def _planes(rng, b, h, w, depth, in_sub="420"):
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    hc = h // 2 if in_sub == "420" else h
    wc = w // 2 if in_sub in ("420", "422") else w
    shape_y = (b, h, w) if b else (h, w)
    shape_c = (b, hc, wc) if b else (hc, wc)
    y = rng.integers(0, hi + 1, shape_y).astype(dt)
    u = rng.integers(0, hi + 1, shape_c).astype(dt)
    v = rng.integers(0, hi + 1, shape_c).astype(dt)
    return y, u, v


def _assert_matches_reference(cfg, lut_size=17, b=2, h=32, w=128):
    rng = np.random.default_rng(7)
    y, u, v = _planes(rng, b, h, w, cfg.in_depth, cfg.in_subsampling)
    prep = prepare_lut(_lut(lut_size)) if lut_size else None
    rsw = (resample_weights((h, w), (cfg.resize[1], cfg.resize[0]))
           if cfg.resize else None)
    got = make_render_fn(prep, cfg)(y, u, v)
    want = render_yuv_reference(y, u, v, cfg, prep, rsw)
    for name, a, e in zip("yuv", got, want):
        a = np.asarray(a)
        assert a.shape == e.shape and a.dtype == e.dtype, (cfg, name)
        d = np.abs(a.astype(np.int64) - e.astype(np.int64))
        assert d.max() <= 1, f"plane {name} max|d|={d.max()} cfg={cfg}"
        frac = float(np.mean(d > 0))
        assert frac < 1e-3, f"plane {name} frac|d|>0={frac} cfg={cfg}"


CASES = {
    "default": dict(),
    "dither_ordered": dict(dither="ordered"),
    "dither_random": dict(dither="random"),
    "10bit_full_range": dict(in_depth=10, out_depth=10, in_full_range=True,
                             dither="ordered"),
    "depth_change_10_to_8": dict(in_depth=10, out_depth=8, dither="random"),
    "8_to_10": dict(in_depth=8, out_depth=10),
    "422_in_422_out_10bit": dict(in_depth=10, out_depth=10,
                                 in_subsampling="422",
                                 out_subsampling="422"),
    "422_in_420_out_dither": dict(in_depth=10, out_depth=8,
                                  in_subsampling="422",
                                  out_subsampling="420", dither="ordered"),
    "420_in_422_out": dict(in_depth=8, out_depth=10, in_subsampling="420",
                           out_subsampling="422", dither="random"),
    "444_roundtrip": dict(in_subsampling="444", out_subsampling="444",
                          dither="ordered"),
    "420_in_444_out": dict(in_subsampling="420", out_subsampling="444"),
    "444_in_420_out": dict(in_subsampling="444", out_subsampling="420"),
    "bilinear_chroma": dict(chroma_up="bilinear"),
    "full_range_to_tv_no_requantize": dict(in_full_range=True,
                                           requantize_intermediate=False),
    "tv_to_full_range_work": dict(work_full_range=True, out_full_range=True),
    "bt601_matrices": dict(matrix_in="bt601", matrix_out="bt601"),
    "bt2020_in_709_out": dict(matrix_in="bt2020nc", matrix_out="bt709",
                              in_depth=10, out_depth=10),
    "plain_layout_420": dict(phase_layout="plain", dither="ordered"),
    "rowphase_layout_420": dict(phase_layout="rowphase", dither="random"),
    "resize_down": dict(resize=(64, 16)),
    "resize_up_10bit_422": dict(resize=(192, 48), in_depth=10, out_depth=10,
                                in_subsampling="422", out_subsampling="422"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_reference(case):
    _assert_matches_reference(RenderConfig(**CASES[case]))


@pytest.mark.parametrize("interp", ["nearest", "trilinear", "tetrahedral",
                                    "pyramid", "prism"])
def test_render_matches_reference_interps(interp):
    _assert_matches_reference(RenderConfig(interp=interp, dither="ordered"))


@pytest.mark.parametrize("n", [33, 65])
def test_render_matches_reference_lut_sizes(n):
    _assert_matches_reference(RenderConfig(in_depth=10, out_depth=8,
                                           dither="ordered"), lut_size=n,
                              b=1, h=16, w=64)


def test_render_matches_reference_no_lut():
    _assert_matches_reference(
        RenderConfig(in_depth=10, in_subsampling="422", dither="ordered",
                     apply_lut=False), lut_size=None)


def test_render_matches_reference_unbatched():
    _assert_matches_reference(RenderConfig(dither="random"), b=0)


def test_render_matches_reference_dci_width():
    """Non-128-multiple widths (the DCI 3996/1998 class)."""
    _assert_matches_reference(RenderConfig(dither="ordered"), b=1, h=16,
                              w=160)
    _assert_matches_reference(RenderConfig(
        in_depth=10, out_depth=10, in_subsampling="422",
        out_subsampling="422", dither="random"), b=1, h=16, w=100)


def test_phase_layout_choice():
    """"auto" takes the row-phase layout for 420 -> 420 nearest without
    resize, and the plain layout elsewhere; both agree bit for bit."""
    from lut_renderer_tpu.ops.render import _rowphase_applicable

    y = np.zeros((2, 32, 128), np.uint8)
    u = np.zeros((2, 16, 64), np.uint8)
    cfg = RenderConfig()
    assert _rowphase_applicable(y, u, cfg)
    assert not _rowphase_applicable(y, u, replace(cfg, phase_layout="plain"))
    assert not _rowphase_applicable(y, u, replace(cfg, chroma_up="bilinear"))
    assert not _rowphase_applicable(y, u, replace(cfg, resize=(64, 16)))
    assert not _rowphase_applicable(
        y, u, replace(cfg, dither="error_diffusion_host"))
    with pytest.raises(ValueError):
        _rowphase_applicable(y, u, replace(cfg, phase_layout="fused"))
    rng = np.random.default_rng(1)
    y, u, v = _planes(rng, 2, 32, 128, 8)
    prep = prepare_lut(_lut(17))
    a = render_yuv_frame(y, u, v, prep, cfg)
    b = render_yuv_frame(y, u, v, prep, replace(cfg, phase_layout="plain"))
    for p, q in zip(a, b):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


def test_reference_rejects_host_dither():
    """Error diffusion finishes on the host (native_ext); the device
    reference refuses it rather than guess."""
    rng = np.random.default_rng(2)
    y, u, v = _planes(rng, 1, 8, 16, 8)
    with pytest.raises(ValueError, match="error_diffusion_host"):
        render_yuv_reference(y, u, v,
                             RenderConfig(dither="error_diffusion_host"),
                             None)
