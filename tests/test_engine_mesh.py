"""Engine auto-sharding over the virtual 8-device mesh (config 5 end-to-end:
decode -> sharded device render -> encode through the full executor)."""

from pathlib import Path

import jax
import numpy as np
import pytest

from lut_renderer_tpu.engine import run_stage
from lut_renderer_tpu.hostio import VideoDecoder, probe_video
from lut_renderer_tpu.models import ProcessingParams
from lut_renderer_tpu.plan import build_render_spec
from lut_renderer_tpu.utils.fixtures import make_gradient_clip


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    return make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=20)


def test_stage_sharded_vs_single_device(clip, tmp_path):
    assert len(jax.devices()) == 8
    info = probe_video(clip)
    outs = {}
    for name, use_mesh in (("sharded", True), ("single", False)):
        out = tmp_path / f"{name}.mov"
        spec = build_render_spec(
            Path(clip), out, ProcessingParams(video_codec="prores_ks"),
            None, info,
        )
        logs = []
        res = run_stage(spec, info, None, log_cb=logs.append,
                        use_mesh=use_mesh)
        assert res.ok, res.error
        if use_mesh:
            assert any("sharded over 8 devices" in m for m in logs)
        with VideoDecoder(out) as dec:
            outs[name] = [f.y.copy() for f in dec]
    assert len(outs["sharded"]) == len(outs["single"]) == 20
    for a, b in zip(outs["sharded"], outs["single"]):
        # ProRes is lossy but deterministic; inputs differ by at most 1 LSB
        # (XLA per-shard fusion), so decoded frames stay within 2 codes.
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
