"""Parity tests: the device LUT core (ops.lut3d, XLA gathers) vs the
colorcore reference interpolators run in NumPy.

The core is colorcore.interp traced with xp=jax.numpy, so on the CPU
backend it must agree with the NumPy run to float32 rounding, for every
interp and the common .cube sizes.
"""

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import INTERP_MODES, Lut3D, apply_lut
from lut_renderer_tpu.ops import prepare_lut
from lut_renderer_tpu.ops.lut3d import apply_lut_planes

H, W = 8, 256
SIZES = (17, 33, 65)


def _rand_rgb_planes(rng, h=H, w=W):
    r = rng.uniform(0, 1, (h, w)).astype(np.float32)
    g = rng.uniform(0, 1, (h, w)).astype(np.float32)
    b = rng.uniform(0, 1, (h, w)).astype(np.float32)
    return r, g, b


def _reference(r, g, b, lut, interp):
    rgb = np.stack([r, g, b], axis=-1)
    out = apply_lut(rgb, lut, interp)
    return out[..., 0], out[..., 1], out[..., 2]


def _noisy_lut(n, seed=42, amp=0.05):
    rng = np.random.default_rng(seed + n)
    lut = Lut3D.identity(n)
    lut.table = np.clip(
        lut.table + rng.uniform(-amp, amp, lut.table.shape
                                ).astype(np.float32), 0, 1)
    return lut


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("interp", INTERP_MODES)
def test_lut_core_matches_reference(interp, n, rng):
    lut = _noisy_lut(n)
    r, g, b = _rand_rgb_planes(rng)
    out = apply_lut_planes(r, g, b, prepare_lut(lut), interp)
    for got, want in zip(out, _reference(r, g, b, lut, interp)):
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-6,
                                   err_msg=f"{interp} {n}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("interp", ["trilinear", "tetrahedral", "pyramid",
                                    "prism"])
def test_lut_core_identity_lut(interp, n, rng):
    """Every interpolating mode reproduces its input through an identity
    LUT (nearest snaps to the lattice, so it is covered by the lattice
    test instead)."""
    r, g, b = _rand_rgb_planes(rng)
    ro, go, bo = apply_lut_planes(r, g, b, prepare_lut(Lut3D.identity(n)),
                                  interp)
    np.testing.assert_allclose(np.asarray(ro), r, atol=1e-6)
    np.testing.assert_allclose(np.asarray(go), g, atol=1e-6)
    np.testing.assert_allclose(np.asarray(bo), b, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("interp", INTERP_MODES)
def test_lut_core_lattice_points_exact(interp, n, rng):
    lut = _noisy_lut(n)
    idx = rng.integers(0, n, size=(H * W, 3))
    rgb = (idx / (n - 1)).astype(np.float32).reshape(H, W, 3)
    ro, go, bo = apply_lut_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                                  prepare_lut(lut), interp)
    want = lut.table[idx[:, 0], idx[:, 1], idx[:, 2]].reshape(H, W, 3)
    np.testing.assert_allclose(np.asarray(ro), want[..., 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(go), want[..., 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(bo), want[..., 2], atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_lut_core_nonaligned_shapes(n, rng):
    """Odd plane shapes and a leading batch axis flow through unchanged."""
    lut = _noisy_lut(n)
    prep = prepare_lut(lut)
    for shape in ((5, 77), (3, 5, 7), (1,)):
        r, g, b = (rng.uniform(0, 1, shape).astype(np.float32)
                   for _ in range(3))
        ro, go, bo = apply_lut_planes(r, g, b, prep, "tetrahedral")
        assert ro.shape == shape and go.shape == shape and bo.shape == shape
        rr, _, _ = _reference(r, g, b, lut, "tetrahedral")
        np.testing.assert_allclose(np.asarray(ro), rr, atol=1e-6)


@pytest.mark.parametrize("interp", INTERP_MODES)
def test_lut_core_domain_mapping(interp, rng):
    """DOMAIN_MIN/MAX map inputs before the lattice math (FFmpeg prelut
    semantics), including inputs outside the domain (clamped)."""
    lut = _noisy_lut(9)
    lut.domain_min = np.array([0.0, 0.1, 0.05], np.float32)
    lut.domain_max = np.array([0.5, 0.9, 1.0], np.float32)
    prep = prepare_lut(lut)
    assert not prep.has_unit_domain
    r, g, b = _rand_rgb_planes(rng)
    out = apply_lut_planes(r, g, b, prep, interp)
    for got, want in zip(out, _reference(r, g, b, lut, interp)):
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)
    ident = Lut3D.identity(9)
    ident.domain_max = np.array([0.5, 0.5, 0.5], np.float32)
    half = np.full((8, 128), 0.25, np.float32)
    ro, _, _ = apply_lut_planes(half, half, half, prepare_lut(ident),
                                "trilinear")
    np.testing.assert_allclose(np.asarray(ro), 0.5, atol=1e-6)


def test_unknown_interp_falls_back_to_tetrahedral(random_lut, rng):
    """The reference validates interp names and falls back to tetrahedral
    (ffmpeg.py:243-244); the core does the same."""
    r, g, b = _rand_rgb_planes(rng, 4, 64)
    ro, _, _ = apply_lut_planes(r, g, b, prepare_lut(random_lut), "cubic")
    rr, _, _ = _reference(r, g, b, random_lut, "tetrahedral")
    np.testing.assert_allclose(np.asarray(ro), rr, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("interp", INTERP_MODES)
def test_edge_values(interp, n):
    """Inputs exactly 0.0 and 1.0 (and beyond) hit the clamped-corner
    paths."""
    lut = _noisy_lut(n)
    r = np.array([[0.0] * 64 + [1.0] * 60 + [-0.5, 1.5, -1e-7, 1 + 1e-7]],
                 np.float32)
    ro, go, bo = apply_lut_planes(r, r, r, prepare_lut(lut), interp)
    for c, plane in enumerate((ro, go, bo)):
        plane = np.asarray(plane)
        np.testing.assert_allclose(plane[0, :64], lut.table[0, 0, 0, c],
                                   atol=1e-6)
        np.testing.assert_allclose(plane[0, 64:124],
                                   lut.table[n - 1, n - 1, n - 1, c],
                                   atol=1e-6)
        np.testing.assert_allclose(
            plane[0, 124:], [lut.table[0, 0, 0, c],
                             lut.table[n - 1, n - 1, n - 1, c],
                             lut.table[0, 0, 0, c],
                             lut.table[n - 1, n - 1, n - 1, c]], atol=1e-6)


def test_delta_e_vs_reference(random_lut):
    """The metric that matters: dE76 of the core vs the float reference is
    float32 rounding, far inside the 0.5 parity budget."""
    from lut_renderer_tpu.colorcore import max_delta_e76

    r, g, b = _rand_rgb_planes(np.random.default_rng(77))
    prep = prepare_lut(random_lut)
    for interp in ("trilinear", "tetrahedral"):
        out = apply_lut_planes(r, g, b, prep, interp)
        got = np.stack([np.asarray(o) for o in out], -1)
        want = np.stack(_reference(r, g, b, random_lut, interp), -1)
        assert max_delta_e76(np.clip(got, 0, 1), np.clip(want, 0, 1)) < 1e-3


def test_lut_agnostic_program_reuse(rng):
    """The table rides as a jit ARGUMENT: two different LUTs of the same
    size must share ONE compiled program (no retrace), and feeding LUT B's
    table through a function traced with LUT A must produce LUT B's
    results. This is the serving contract: a warmed cache runs never-seen
    .cube files with 0 compiles."""
    import jax

    lut_a, lut_b = _noisy_lut(33, seed=1), _noisy_lut(33, seed=2)
    prep_a, prep_b = prepare_lut(lut_a), prepare_lut(lut_b)

    @jax.jit
    def f(r, g, b, table):
        return apply_lut_planes(r, g, b, prep_a, "tetrahedral", table=table)

    r, g, b = _rand_rgb_planes(rng, 8, 128)
    out_a = f(r, g, b, prep_a.table)
    n_compiles = f._cache_size()
    out_b = f(r, g, b, prep_b.table)
    assert f._cache_size() == n_compiles  # no retrace for the new LUT
    rb, gb, bb = _reference(r, g, b, lut_b, "tetrahedral")
    np.testing.assert_allclose(np.asarray(out_b[0]), rb, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_b[2]), bb, atol=1e-6)
    assert not np.allclose(np.asarray(out_a[0]), np.asarray(out_b[0]))


def test_make_render_fn_operand_args(rng):
    """make_render_fn passes the LUT table as a device argument; results
    must match the direct (constant-baked) render path exactly, and a
    second LUT of the same size reuses the cached jitted function."""
    from lut_renderer_tpu.ops.render import (RenderConfig, make_render_fn,
                                             prep_static_key,
                                             render_yuv_frame)

    prep = prepare_lut(_noisy_lut(17, amp=0.03))
    cfg = RenderConfig(interp="tetrahedral")
    y = rng.integers(16, 236, (2, 32, 128), dtype=np.uint8)
    u = rng.integers(16, 241, (2, 16, 64), dtype=np.uint8)
    v = rng.integers(16, 241, (2, 16, 64), dtype=np.uint8)
    got = make_render_fn(prep, cfg)(y, u, v)
    want = render_yuv_frame(y, u, v, prep, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    other = prepare_lut(_noisy_lut(17, seed=5))
    assert prep_static_key(other, cfg) == prep_static_key(prep, cfg)
    assert prep_static_key(other, RenderConfig(apply_lut=False)) is None


@pytest.mark.parametrize("n", [16, 32, 64])
def test_even_sized_luts(n, rng):
    """Even grid sizes (16/32/64 are common .cube sizes), including exact
    1.0 inputs that hit the p == n-1 clamp, for every interp."""
    lut = _noisy_lut(n)
    prep = prepare_lut(lut)
    P = 1024
    rs = rng.uniform(0, 1, (1, P)).astype(np.float32)
    gs = rng.uniform(0, 1, (1, P)).astype(np.float32)
    bs = rng.uniform(0, 1, (1, P)).astype(np.float32)
    gs[0, :64] = 1.0           # ties + clamp paths
    bs[0, :32] = 1.0
    rs[0, :8] = 1.0
    for interp in INTERP_MODES:
        out = apply_lut_planes(rs, gs, bs, prep, interp)
        for got, want in zip(out, _reference(rs, gs, bs, lut, interp)):
            np.testing.assert_allclose(np.asarray(got), want, atol=1e-6,
                                       err_msg=f"{n} {interp}")
