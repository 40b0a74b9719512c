"""The N >= 97 LUT class: colorcore.cube promises MAX_LUT_SIZE = 129
(cube.py:25); these tests back the promise end to end — parsing, device
LUT core parity against the f32 reference AND FFmpeg's own lut3d filter
(the reference accepts any N because FFmpeg's lut3d is an interpreter,
reference ffmpeg.py:243-244)."""

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import (
    Lut3D,
    apply_lut,
    max_delta_e76,
    parse_cube,
    write_cube_file,
)
from lut_renderer_tpu.colorcore.cube import CubeParseError
from lut_renderer_tpu.ops.lut3d import apply_lut_planes
from lut_renderer_tpu.ops.prepare import prepare_lut


def _bigcube(n, seed=5):
    rng = np.random.default_rng(seed)
    lut = Lut3D.identity(n)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.03, 0.03, lut.table.shape
                                ).astype(np.float32), 0, 1)
    return lut


@pytest.fixture(scope="module")
def prep97():
    return prepare_lut(_bigcube(97))


@pytest.fixture(scope="module")
def prep129():
    return prepare_lut(_bigcube(129))


def test_parse_envelope(tmp_path):
    # the advertised ceiling parses; one past it is rejected
    small = Lut3D.identity(2)
    text = write_cube_file(tmp_path / "t.cube", small).read_text()
    ok = text.replace("LUT_3D_SIZE 2", "LUT_3D_SIZE 129")
    with pytest.raises(CubeParseError, match="expected 6440067 values"):
        parse_cube(ok, "t")  # size accepted, data short -> data error
    bad = text.replace("LUT_3D_SIZE 2", "LUT_3D_SIZE 130")
    with pytest.raises(CubeParseError, match="unsupported LUT_3D_SIZE"):
        parse_cube(bad, "t")


@pytest.mark.parametrize("interp", ["nearest", "trilinear", "tetrahedral",
                                    "pyramid", "prism"])
@pytest.mark.parametrize("n", [97, 129])
def test_kernel_parity_vs_reference(n, interp, prep97, prep129, rng):
    """The device LUT core (XLA gathers) against the f32 reference at the
    big sizes: float32 rounding only — the work per pixel does not grow
    with N, and the 129^3 table (25.8 MB) is read like any other."""
    prep = prep97 if n == 97 else prep129
    pts = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    pts[:8] = 1.0
    ref = apply_lut(pts, prep.table, interp)
    ro, go, bo = apply_lut_planes(pts[:, 0], pts[:, 1], pts[:, 2], prep,
                                  interp)
    out = np.stack([np.asarray(ro), np.asarray(go), np.asarray(bo)], -1)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert max_delta_e76(np.clip(out, 0, 1), np.clip(ref, 0, 1)) < 1e-3


def test_oracle_parity_97(tmp_path, rng):
    """97^3 against FFmpeg's own lut3d (the bundled libavfilter)."""
    from lut_renderer_tpu.hostio.oracle import Lut3DOracle

    lut = _bigcube(97, seed=11)
    path = write_cube_file(tmp_path / "p97.cube", lut)
    rgb = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    for interp in ("tetrahedral", "trilinear"):
        with Lut3DOracle(path, interp, "gbrpf32le", 64, 64) as oracle:
            ffm = oracle.apply_rgb_float(rgb)
        ours = apply_lut(rgb, lut, interp)
        assert max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1)) < 0.01


def test_oracle_parity_129(tmp_path, rng):
    """129^3 production contract: the device LUT core against the REAL
    lut3d filter output, inside the dE76 budget."""
    from lut_renderer_tpu.hostio.oracle import Lut3DOracle

    lut = _bigcube(129, seed=13)
    path = write_cube_file(tmp_path / "p129.cube", lut)
    rgb = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    with Lut3DOracle(path, "tetrahedral", "gbrpf32le", 32, 32) as oracle:
        ffm = oracle.apply_rgb_float(rgb)
    prep = prepare_lut(lut)
    ro, go, bo = apply_lut_planes(
        rgb[..., 0], rgb[..., 1], rgb[..., 2], prep, "tetrahedral")
    ours = np.stack([np.asarray(ro), np.asarray(go), np.asarray(bo)], -1)
    de = max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1))
    assert de < 0.5, de
