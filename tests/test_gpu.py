"""Card-only tests (marker `gpu`): the device paths compiled for an NVIDIA
GPU, against the NumPy references. They skip without a card; on the card:

    LUT_TPU_TEST_GPU=1 python -m pytest tests -m gpu

(chip_smoke.py runs them as its last phase.)
"""

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import INTERP_MODES, apply_lut
from lut_renderer_tpu.colorcore.pipeline import render_yuv_reference
from lut_renderer_tpu.ops import RenderConfig, prepare_lut
from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("interp", INTERP_MODES)
def test_lut_core_on_gpu(gpu, interp):
    """The gather core compiled for the card, at 1080p: float32 rounding
    away from the NumPy interpolators."""
    import jax

    from lut_renderer_tpu.ops.lut3d import apply_lut_planes

    lut = noisy_lut(33, seed=9)
    prep = prepare_lut(lut)
    rgb = np.random.default_rng(1).uniform(0, 1, (1080, 1920, 3)
                                           ).astype(np.float32)
    planes = [jax.device_put(rgb[..., c], gpu) for c in range(3)]
    out = jax.jit(lambda r, g, b: apply_lut_planes(r, g, b, prep, interp))(
        *planes)
    assert out[0].devices() == {gpu}
    got = np.stack([np.asarray(o) for o in out], -1)
    np.testing.assert_allclose(got, apply_lut(rgb, lut, interp), atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(),
    dict(in_depth=10, out_depth=8, dither="ordered"),
    dict(in_depth=10, out_depth=10, in_subsampling="422",
         out_subsampling="422", dither="random"),
    dict(in_full_range=True, chroma_up="bilinear"),
    dict(resize=(960, 540)),
], ids=["420_8bit", "10_to_8_ordered", "422_10bit_random",
        "fullrange_bilinear", "resize"])
def test_render_step_on_gpu(gpu, case):
    """make_render_fn on the card at 1080p against the NumPy pipeline:
    at most 1 code value off, on fewer than 1e-3 of the samples."""
    from lut_renderer_tpu.ops.render import make_render_fn
    from lut_renderer_tpu.ops.resample import resample_weights

    cfg = RenderConfig(**case)
    rng = np.random.default_rng(2)
    h, w = 1080, 1920
    y, u, v = yuv_batch(rng, 2, h, w, cfg, full_scale=True)
    prep = prepare_lut(noisy_lut(33, seed=9))
    got = make_render_fn(prep, cfg)(y, u, v)
    rsw = (resample_weights((h, w), (cfg.resize[1], cfg.resize[0]))
           if cfg.resize else None)
    want = render_yuv_reference(y, u, v, cfg, prep, rsw)
    for a, e in zip(got, want):
        a = np.asarray(a)
        assert a.shape == e.shape and a.dtype == e.dtype
        d = np.abs(a.astype(np.int64) - e.astype(np.int64))
        assert d.max() <= 1 and float(np.mean(d > 0)) < 1e-3


def test_resize_matmuls_keep_float32_on_gpu(gpu):
    """Precision.HIGHEST keeps the resize einsums out of TF32 on the card:
    a 10-bit-scale plane resampled 4K -> 1080p stays within 1e-2 code
    values of a float64 NumPy product (TF32's 10-bit mantissa would miss
    by tenths of a code value)."""
    import jax

    from lut_renderer_tpu.ops.resample import resample_plane, resample_weights

    x = np.random.default_rng(3).uniform(0, 1023, (2160, 3840)
                                          ).astype(np.float32)
    wv, wh = resample_weights((2160, 3840), (1080, 1920))
    got = np.asarray(jax.jit(resample_plane)(jax.device_put(x, gpu), wv, wh))
    want = (wv.astype(np.float64) @ x.astype(np.float64)
            @ wh.astype(np.float64).T)
    assert np.abs(got - want).max() < 1e-2
