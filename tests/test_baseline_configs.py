"""The five BASELINE.json workload configs as end-to-end scenario tests.

Scaled down for the CPU test environment (resolutions shrunk, gather LUT
strategy); the real-size numbers come from bench.py on the chip. Encoder
substitutions where the bundled libs lack a codec are the documented
graceful-degradation policy (libx264 -> mpeg4 at template level).
"""

from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.engine import run_stage
from lut_renderer_tpu.hostio import VideoDecoder, probe_video
from lut_renderer_tpu.models import ProcessingParams
from lut_renderer_tpu.plan import build_render_spec
from lut_renderer_tpu.tasks import TaskManager, TaskRunner
from lut_renderer_tpu.models import Task
from lut_renderer_tpu.utils.fixtures import (
    make_10bit_prores_clip,
    make_fullrange_clip,
    make_gradient_clip,
    make_vfr_clip,
)


@pytest.fixture(scope="module")
def lut33(tmp_path_factory):
    rng = np.random.default_rng(5)
    lut = Lut3D.identity(33)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.03, 0.03, lut.table.shape).astype(np.float32),
        0, 1,
    )
    return write_cube_file(tmp_path_factory.mktemp("bl") / "l33.cube", lut)


@pytest.fixture(scope="module")
def lut65(tmp_path_factory):
    lut = Lut3D.identity(65)
    lut.table = np.clip(lut.table**1.1, 0, 1).astype(np.float32)
    return write_cube_file(tmp_path_factory.mktemp("bl65") / "l65.cube", lut)


def test_config1_fast_delivery_trilinear_33(tmp_path, lut33):
    """C1: 8-bit clip + 33^3 LUT, trilinear, fast delivery -> 8-bit 4:2:0."""
    clip = make_gradient_clip(tmp_path / "c1.mp4", 96, 64, frames=8)
    info = probe_video(clip)
    out = tmp_path / "c1_out.mp4"
    spec = build_render_spec(
        Path(clip), out,
        ProcessingParams(video_codec="mpeg4", lut_interp="trilinear",
                         bitrate="2M"),
        Path(lut33), info,
    )
    assert spec.lut_interp == "trilinear"
    from lut_renderer_tpu.tasks.runner import load_prepared_lut

    res = run_stage(spec, info, load_prepared_lut(Path(lut33)))
    assert res.ok, res.error
    oinfo = probe_video(out)
    assert oinfo.pix_fmt == "yuv420p"
    assert oinfo.color_range == "tv" and oinfo.colorspace == "bt709"


def test_config2_65cube_tetra_10bit_to_8bit_dither(tmp_path, lut65):
    """C2: 65^3 LUT, tetrahedral, 10-bit source -> forced 8-bit with dither."""
    clip = make_10bit_prores_clip(tmp_path / "c2.mov", 192, 108, frames=4)
    info = probe_video(clip)
    assert info.bit_depth == 10
    out = tmp_path / "c2_out.mov"
    spec = build_render_spec(
        Path(clip), out,
        ProcessingParams(video_codec="mpeg4", lut_interp="tetrahedral",
                         bit_depth_policy="force_8bit",
                         zscale_dither="error_diffusion"),
        Path(lut65), info,
    )
    assert spec.pix_fmt == "yuv420p"
    from lut_renderer_tpu.tasks.runner import load_prepared_lut

    res = run_stage(spec, info, load_prepared_lut(Path(lut65)))
    assert res.ok, res.error
    oinfo = probe_video(out)
    assert oinfo.bit_depth == 8
    # banding check on the smooth ramp: dithered output uses intermediate
    # codes, not 4-wide steps only
    with VideoDecoder(out) as dec:
        fr = dec.read_frame()
    row = fr.y[10].astype(int)
    assert len(np.unique(row)) > 100  # a hard-banded 8-bit ramp would be ~96


def test_config3_pro_two_stage_10bit_mastering(tmp_path, lut33):
    """C3: 10-bit two-stage mastering: LUT -> prores_ks yuv422p10le master ->
    distribution encode with BT.709/tv tagging."""
    clip = make_10bit_prores_clip(tmp_path / "c3.mov", 192, 108, frames=4)
    info = probe_video(clip)
    master_dir = tmp_path / "masters"
    master_dir.mkdir()
    task = Task(
        task_id="c3",
        source_path=Path(clip),
        output_path=tmp_path / "c3_out.mov",
        lut_path=Path(lut33),
        cover_path=None,
        params=ProcessingParams(processing_mode="pro", video_codec="prores_ks"),
        source_info=info,
        intermediate_path=master_dir / "c3_master.mov",
    )
    runner = TaskRunner(task)
    statuses, logs = [], []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    runner.log.connect(lambda tid, m: logs.append(m))
    runner.run()
    assert statuses == ["completed"], logs[-3:]
    assert not (master_dir / "c3_master.mov").exists()  # cleaned up
    oinfo = probe_video(task.output_path)
    assert oinfo.pix_fmt == "yuv422p10le" and oinfo.bit_depth == 10
    assert oinfo.color_primaries == "bt709" and oinfo.color_range == "tv"
    assert any("Master fixed to ProRes" in m for m in logs)


def test_config4_mixed_queue_yuvj_vfr_inherit(tmp_path, lut33):
    """C4: batch queue of mixed clips — full-range normalization, VFR->CFR
    force, inherit-color-metadata policy."""
    full = make_fullrange_clip(tmp_path / "c4a.mp4")
    vfr = make_vfr_clip(tmp_path / "c4b.mp4")
    info_full = probe_video(full)
    assert info_full.is_full_range
    info_vfr = probe_video(vfr)
    assert info_vfr.is_vfr

    mgr = TaskManager(max_concurrency=2)
    t1 = Task("c4a", Path(full), tmp_path / "c4a_out.mp4", Path(lut33), None,
              ProcessingParams(video_codec="mpeg4",
                               lut_output_tags="inherit"),
              source_info=info_full)
    t2 = Task("c4b", Path(vfr), tmp_path / "c4b_out.mp4", Path(lut33), None,
              ProcessingParams(video_codec="mpeg4", force_cfr=True),
              source_info=info_vfr)
    notes = []
    mgr.task_log.connect(lambda tid, m: notes.append((tid, m)))
    mgr.add_tasks([t1, t2])
    mgr.start_all()
    assert mgr.wait_all(timeout=300)
    assert t1.status.value == "completed" and t2.status.value == "completed"
    assert any("full-range (pc)" in m for tid, m in notes if tid == "c4a")
    assert any("forcing CFR" in m for tid, m in notes if tid == "c4b")
    assert not probe_video(t2.output_path).is_vfr


def test_config5_frame_sharded_multichip(rng, lut33):
    """C5: frame-sharded multi-chip pipeline (8-device virtual mesh stands in
    for the 8K multi-chip config; real-chip numbers come from bench.py)."""
    import jax

    from lut_renderer_tpu.colorcore import parse_cube_file
    from lut_renderer_tpu.ops import RenderConfig, prepare_lut
    from lut_renderer_tpu.ops.render import render_yuv_frame
    from lut_renderer_tpu.parallel import default_mesh, make_sharded_render_fn
    from lut_renderer_tpu.parallel.sharding import put_sharded

    prep = prepare_lut(parse_cube_file(lut33))
    mesh = default_mesh()
    cfg = RenderConfig(interp="tetrahedral")
    # 8K aspect at 1/20 scale, one frame per device
    h, w = 216, 384
    y = rng.integers(16, 236, (8, h, w), dtype=np.uint8)
    u = rng.integers(16, 241, (8, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(16, 241, (8, h // 2, w // 2), dtype=np.uint8)
    fn = make_sharded_render_fn(prep, cfg, mesh)
    yq, uq, vq = fn(*put_sharded(mesh, y, u, v))
    ref = render_yuv_frame(y, u, v, prep, cfg)
    diff = np.abs(np.asarray(yq).astype(int) - np.asarray(ref[0]).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert len(yq.sharding.device_set) == 8
