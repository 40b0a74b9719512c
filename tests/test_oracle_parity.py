"""Parity against FFmpeg's own lut3d filter (the bundled libavfilter C code).

This is the headline correctness gate from BASELINE.md: max dE76 < 0.5 on
both interpolation modes. Measured here in float (gbrpf32) against the
colorcore reference; the device LUT core is tied to colorcore by test_lut3d_op
(maxerr ~1e-7), so transitively the kernel matches lut3d.
"""

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import Lut3D, apply_lut, max_delta_e76, write_cube_file
from lut_renderer_tpu.hostio.oracle import Lut3DOracle


@pytest.fixture(scope="module")
def cube33(tmp_path_factory, ):
    rng = np.random.default_rng(7)
    lut = Lut3D.identity(33)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.05, 0.05, lut.table.shape).astype(np.float32),
        0, 1,
    )
    path = write_cube_file(tmp_path_factory.mktemp("o") / "p.cube", lut)
    return path, lut


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear", "nearest", "pyramid", "prism"])
def test_parity_vs_ffmpeg_lut3d(cube33, interp, rng):
    path, lut = cube33
    rgb = rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    with Lut3DOracle(path, interp, "gbrpf32le", 128, 128) as oracle:
        ffm = oracle.apply_rgb_float(rgb)
    ours = apply_lut(rgb, lut, interp)
    de = max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1))
    assert de < 0.01, f"{interp}: dE76 {de} (budget is 0.5; we hold 0.01)"
    assert float(np.abs(ffm - ours).max()) < 1e-5


def test_parity_gradient_extremes(cube33):
    """Lattice-edge and extreme inputs through the real filter."""
    path, lut = cube33
    ramp = np.linspace(0, 1, 128 * 128, dtype=np.float32)
    rgb = np.stack([ramp, ramp[::-1], np.abs(1 - 2 * ramp)], -1).reshape(128, 128, 3)
    with Lut3DOracle(path, "tetrahedral", "gbrpf32le", 128, 128) as oracle:
        ffm = oracle.apply_rgb_float(rgb)
    ours = apply_lut(rgb, lut, "tetrahedral")
    assert max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1)) < 0.01


def test_rgb48_path(cube33):
    """Integer (rgb48) path: FFmpeg scales by (N-1)/65535 — our reference on
    normalized input matches within 1 16-bit LSB."""
    path, lut = cube33
    rng = np.random.default_rng(3)
    rgb16 = rng.integers(0, 65536, (64, 64, 3), dtype=np.uint16)
    with Lut3DOracle(path, "tetrahedral", "rgb48le", 64, 64) as oracle:
        out16 = oracle.apply_rgb48(rgb16)
    ours = apply_lut((rgb16.astype(np.float32) / 65535.0), lut, "tetrahedral")
    got = out16.astype(np.float32) / 65535.0
    assert float(np.abs(got - ours).max()) < 2.0 / 65535.0


def test_parity_65cube(tmp_path):
    """65^3 LUTs (config 2's size) hold the same parity."""
    rng = np.random.default_rng(13)
    lut = Lut3D.identity(65)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.03, 0.03, lut.table.shape).astype(np.float32),
        0, 1,
    )
    path = write_cube_file(tmp_path / "p65.cube", lut)
    rgb = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    for interp in ("tetrahedral", "trilinear"):
        with Lut3DOracle(path, interp, "gbrpf32le", 64, 64) as oracle:
            ffm = oracle.apply_rgb_float(rgb)
        ours = apply_lut(rgb, lut, interp)
        assert max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1)) < 0.01


def test_auto_kernel_vs_ffmpeg_lut3d_direct(cube33, rng):
    """The PRODUCTION path, end to end: the device LUT core directly
    against FFmpeg's own lut3d output — not via the colorcore reference.
    This is the same contract bench.py reports from the device
    (max_dE76_vs_lut3d)."""
    import jax.numpy as jnp

    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.lut3d import apply_lut_planes

    path, lut = cube33
    rgb = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    with Lut3DOracle(path, "tetrahedral", "gbrpf32le", 64, 64) as oracle:
        ffm = oracle.apply_rgb_float(rgb)
    prep = prepare_lut(lut)
    ro, go, bo = apply_lut_planes(
        jnp.asarray(rgb[..., 0]), jnp.asarray(rgb[..., 1]),
        jnp.asarray(rgb[..., 2]), prep, "tetrahedral")
    ours = np.stack([np.asarray(ro), np.asarray(go), np.asarray(bo)], -1)
    de = max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1))
    assert de < 0.5, f"dE76 {de} vs real lut3d"
