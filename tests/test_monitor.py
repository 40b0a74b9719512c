"""Interactive queue monitor tests (rendering + key handling, no tty).

Covers the VERDICT round-1 gap #9: an interactive analog of the reference's
live window (aggregate %, per-row progress, cancel one task while others
run) — main_window.py:331-371 + 1979-2119.
"""

import io
import threading
import time
from pathlib import Path

import pytest

from lut_renderer_tpu.app.monitor import (
    QueueMonitor,
    aggregate_progress,
    handle_key,
    progress_bar,
    render_frame,
)
from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.hostio import probe_video
from lut_renderer_tpu.models import ProcessingParams, Task, TaskStatus
from lut_renderer_tpu.tasks import TaskManager
from lut_renderer_tpu.utils.fixtures import make_gradient_clip


def _mk_task(i, status=TaskStatus.PENDING, progress=0, error=""):
    t = Task(
        task_id=f"m{i}",
        source_path=Path(f"/x/clip_{i}.mp4"),
        output_path=Path(f"/x/out_{i}.mp4"),
        lut_path=None,
        cover_path=None,
        params=ProcessingParams(),
        source_info=None,
    )
    t.status = status
    t.progress = progress
    t.error = error
    return t


def test_progress_bar_and_aggregate():
    assert progress_bar(0) == "[··········]"
    assert progress_bar(100) == "[██████████]"
    assert progress_bar(55).count("█") == 5
    tasks = [_mk_task(0, progress=100), _mk_task(1, progress=0)]
    assert aggregate_progress(tasks) == 50
    assert aggregate_progress([]) == 0


def test_render_frame_rows_and_truncation():
    tasks = [
        _mk_task(0, TaskStatus.RUNNING, 61),
        _mk_task(1, TaskStatus.FAILED, 30, error="encoder open failed"),
        _mk_task(2, TaskStatus.COMPLETED, 100),
    ]
    lines = render_frame(tasks, width=72)
    assert len(lines) == 5  # header + 3 rows + footer
    assert "3 tasks" in lines[0] and "63%" in lines[0]
    assert "[1]" in lines[1] and "running" in lines[1] and "61%" in lines[1]
    assert "FAILED" in lines[2] and "encoder" in lines[2]
    assert all(len(line) <= 72 for line in lines)


def test_handle_key_cancel_semantics():
    mgr = TaskManager()
    done = _mk_task(0, TaskStatus.COMPLETED, 100)
    pend = _mk_task(1)
    mgr.add_tasks([done, pend])
    tasks = list(mgr.tasks.values())
    # canceling a finished row is a no-op (guarded in the manager)
    note = handle_key("1", mgr, tasks)
    assert "already completed" in note
    assert done.status == TaskStatus.COMPLETED
    note = handle_key("2", mgr, tasks)
    assert "canceled [2]" in note
    assert pend.status == TaskStatus.CANCELED
    assert handle_key("q", mgr, tasks) == "quit"
    assert handle_key("z", mgr, tasks) is None


def test_monitor_cancels_one_of_three_live_tasks(tmp_path):
    """Cancel ONE task by key while the queue runs; the others complete and
    the manager's state stays consistent (the VERDICT 'done' criterion)."""
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=8)
    lut = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    info = probe_video(clip)

    def task(i):
        return Task(
            task_id=f"live{i}",
            source_path=Path(clip),
            output_path=tmp_path / f"w{i}_out.mov",
            lut_path=Path(lut),
            cover_path=None,
            params=ProcessingParams(video_codec="prores_ks"),
            source_info=info,
        )

    mgr = TaskManager(max_concurrency=1)
    tasks = [task(0), task(1), task(2)]
    mgr.add_tasks(tasks)
    stream = io.StringIO()
    mon = QueueMonitor(mgr, stream=stream, refresh_hz=50.0)
    mgr.start_all()
    # cancel row 2 (still pending behind the concurrency=1 queue)
    mon.on_key("2")
    mon.run()
    assert mgr.wait_all(timeout=300)
    assert tasks[1].status == TaskStatus.CANCELED
    assert not tasks[1].output_path.exists()
    assert tasks[0].status == TaskStatus.COMPLETED
    assert tasks[2].status == TaskStatus.COMPLETED
    assert tasks[0].output_path.exists() and tasks[2].output_path.exists()
    out = stream.getvalue()
    assert "lut-tpu queue" in out and "canceled [2]" in out


def test_monitor_quit_key_stops_view_not_queue(tmp_path):
    mgr = TaskManager()
    t = _mk_task(0)
    mgr.add_task(t)
    stream = io.StringIO()
    mon = QueueMonitor(mgr, stream=stream, refresh_hz=50.0)
    mon.on_key("q")
    mon.run()  # returns immediately; no exception, frame drawn once
    assert "lut-tpu queue" in stream.getvalue()
    assert t.status == TaskStatus.PENDING  # queue untouched
