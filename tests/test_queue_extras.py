"""Reprocess, queue persistence/resume, VFR detection + CFR forcing, doctor."""

from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.app.cli import main as cli_main
from lut_renderer_tpu.hostio import probe_video
from lut_renderer_tpu.models import ProcessingParams, Task, TaskStatus
from lut_renderer_tpu.tasks import TaskManager
from lut_renderer_tpu.utils.fixtures import make_gradient_clip, make_vfr_clip


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("qx")
    return make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=8)


def _task(clip, out):
    return Task(
        task_id=f"t-{out.stem}",
        source_path=Path(clip),
        output_path=out,
        lut_path=None,
        cover_path=None,
        params=ProcessingParams(video_codec="mpeg4"),
        source_info=probe_video(clip),
    )


def test_reprocess(clip, tmp_path):
    mgr = TaskManager()
    t = _task(clip, tmp_path / "r_out.mp4")
    mgr.add_task(t)
    mgr.start_all()
    assert mgr.wait_all(timeout=300)
    assert t.status == TaskStatus.COMPLETED
    first_out = t.output_path
    assert first_out.exists()

    assert mgr.reprocess_task(t.task_id)
    assert t.status == TaskStatus.PENDING
    assert t.progress == 0 and t.started_at is None
    assert t.output_path != first_out  # fresh anti-collision name
    mgr.start_all()
    assert mgr.wait_all(timeout=300)
    assert t.status == TaskStatus.COMPLETED
    assert t.output_path.exists() and first_out.exists()


def test_reprocess_refuses_running():
    mgr = TaskManager()
    t = Task("x", Path("/a"), Path("/b"), None, None, ProcessingParams())
    t.status = TaskStatus.RUNNING
    mgr.tasks["x"] = t
    assert not mgr.reprocess_task("x")


def test_queue_save_load_roundtrip(clip, tmp_path):
    mgr = TaskManager()
    done = _task(clip, tmp_path / "d_out.mp4")
    done.status = TaskStatus.COMPLETED
    done.progress = 100
    interrupted = _task(clip, tmp_path / "i_out.mp4")
    interrupted.status = TaskStatus.RUNNING
    interrupted.progress = 37
    mgr.tasks[done.task_id] = done
    mgr.tasks[interrupted.task_id] = interrupted
    qfile = tmp_path / "queue.json"
    mgr.save_queue(qfile)

    mgr2 = TaskManager()
    n = mgr2.load_queue(qfile, probe=False)
    assert n == 2
    t_done = mgr2.tasks[done.task_id]
    t_int = mgr2.tasks[interrupted.task_id]
    assert t_done.status == TaskStatus.COMPLETED
    # interrupted RUNNING tasks come back PENDING
    assert t_int.status == TaskStatus.PENDING
    assert t_done.params.video_codec == "mpeg4"


def test_queue_file_from_older_version_loads(tmp_path, monkeypatch):
    """Queue and settings files written when the LUT kernel had options
    (tests/data/legacy_*.json: strategy and precision keys) still load:
    the unknown keys are ignored, wherever they sit."""
    import json
    import shutil

    from lut_renderer_tpu.app import settings as settings_mod

    data = Path(__file__).resolve().parent / "data"
    mgr = TaskManager()
    assert mgr.load_queue(data / "legacy_queue.json", probe=False) == 1
    task = mgr.tasks["old-1"]
    assert task.status == TaskStatus.PENDING
    assert task.params == ProcessingParams(video_codec="mpeg4")

    monkeypatch.setenv("LUT_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    (tmp_path / "cfg").mkdir()
    shutil.copy(data / "legacy_settings.json", settings_mod.settings_path())
    loaded = settings_mod.load_settings()
    assert loaded == json.loads((data / "legacy_settings.json").read_text())
    params = ProcessingParams.from_dict(loaded["last_params"])
    assert params == ProcessingParams(video_codec="ffv1")


def test_cli_resume_runs_pending(clip, tmp_path, capsys):
    mgr = TaskManager()
    t = _task(clip, tmp_path / "res_out.mp4")
    mgr.add_task(t)
    qfile = tmp_path / "q.json"
    mgr.save_queue(qfile)
    rc = cli_main(["resume", str(qfile)])
    out = capsys.readouterr().out
    assert "loaded 1 tasks (1 pending)" in out
    assert rc == 0
    assert (tmp_path / "res_out.mp4").exists()


def test_vfr_fixture_probes_as_vfr(tmp_path):
    clip = make_vfr_clip(tmp_path / "vfr.mp4")
    info = probe_video(clip)
    assert info.avg_fps and info.r_fps
    assert abs(info.avg_fps - info.r_fps) > 0.1
    assert info.is_vfr


def test_vfr_forced_cfr_end_to_end(tmp_path):
    """VFR source + force_cfr: output frame count matches duration x rate
    (dup/drop applied by the frame scheduler)."""
    from lut_renderer_tpu.engine import run_stage
    from lut_renderer_tpu.plan import build_render_spec

    clip = make_vfr_clip(tmp_path / "vfr2.mp4", frames=40)
    info = probe_video(clip)
    out = tmp_path / "cfr_out.mp4"
    spec = build_render_spec(
        clip, out, ProcessingParams(video_codec="mpeg4", force_cfr=True),
        None, info,
    )
    assert spec.fps_mode == "cfr"
    res = run_stage(spec, info, None)
    assert res.ok, res.error
    oinfo = probe_video(out)
    assert not oinfo.is_vfr
    # ~duration * rate frames (VFR in = 40 frames over 80 ticks @50 = 1.6s)
    want = info.duration * oinfo.fps
    assert abs(oinfo.nb_frames - want) <= max(3, 0.1 * want)


def test_cli_doctor(capsys):
    rc = cli_main(["doctor"])
    out = capsys.readouterr().out
    assert "bundled FFmpeg libs" in out and "ok" in out
    assert "prores_ks" in out
    assert rc == 0


def test_resume_redo_reenqueues_finished(tmp_path):
    """`resume --redo`: finished tasks come back PENDING with fresh output
    names (the reference's per-row reprocess, queue-wide)."""
    from lut_renderer_tpu.app.cli import main as cli_main
    from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=4)
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    q = tmp_path / "q.json"
    rc = cli_main(["render", str(clip), "--lut", str(cube),
                   "--codec", "mpeg4", "--bitrate", "1M",
                   "--out-dir", str(tmp_path / "out"),
                   "--save-queue", str(q)])
    assert rc == 0
    rc = cli_main(["resume", str(q), "--redo"])
    assert rc == 0
    outs = sorted(p.name for p in (tmp_path / "out").glob("*.mp4"))
    assert outs == ["c_out.mp4", "c_out_1.mp4"]
