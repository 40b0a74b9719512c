"""scripts/trace_render.py's per-kernel byte count: XLA's own bytes-accessed
estimate for each instruction of the compiled program. The trace itself
needs the card; the byte count runs on any backend."""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lut_renderer_tpu.ops import RenderConfig, prepare_lut
from lut_renderer_tpu.ops.render import render_yuv_frame
from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch


@pytest.fixture(scope="module")
def trace_render():
    spec = importlib.util.spec_from_file_location(
        "trace_render", "scripts/trace_render.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sliced_operand_counts_what_is_read(trace_render):
    """A fusion that reads 8 of 1024 columns is charged for those 8, not
    for its whole operand."""
    x = np.ones((64, 1024), np.float32)
    compiled = jax.jit(lambda x: (x[:, :8] * 2, jnp.sin(x))).lower(x).compile()
    xb = trace_render.xla_bytes_by_instruction(compiled.as_text())
    assert sorted(xb.values()) == [2 * 64 * 8 * 4, 2 * 64 * 1024 * 4]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(in_depth=10, out_depth=10, in_subsampling="422",
         out_subsampling="422"),
], ids=["420_8bit", "422_10bit"])
def test_instructions_sum_to_program_estimate(trace_render, kw):
    """Split over the render step's instructions, the estimates add up to
    XLA's estimate for the whole program, and none is missing."""
    cfg = RenderConfig(**kw)
    prep = prepare_lut(noisy_lut(17))
    y, u, v = yuv_batch(np.random.default_rng(0), 2, 64, 128, cfg)
    compiled = jax.jit(lambda y, u, v, t: render_yuv_frame(
        y, u, v, prep, cfg, lut_table=t)).lower(y, u, v, prep.table).compile()
    xb = trace_render.xla_bytes_by_instruction(compiled.as_text())
    assert xb and all(b is not None for b in xb.values())
    total = compiled.cost_analysis()["bytes accessed"]
    assert sum(xb.values()) == pytest.approx(total, rel=1e-3)
