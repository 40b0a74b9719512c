"""TaskRunner: executes one Task's render stages on a worker thread.

Reference contract (src/lut_renderer/task_manager.py:29-216):
  * build the stage pipeline, then per stage: optional re-probe of the stage
    input (pro mode's intermediate master, task_manager.py:66-71), plan
    construction with accumulated notes, execution, progress mapping;
  * progress: single stage 0..100; two stages split 50/50 with non-final
    stages capped at span-1 and overall 99 until the last finishes
    (task_manager.py:86-91, 170-190);
  * cancel: cooperative, ends the in-flight stage and reports CANCELED;
  * on success: optional cover extraction, then unlink stages marked
    cleanup_on_success (the ProRes master), progress 100, COMPLETED;
  * any exception -> FAILED with the message in task.error.

Unlike the reference (which leaks the intermediate master on failure/cancel,
acknowledged in its readme), failed/canceled pro runs clean up the master —
SURVEY.md §5.3 marks this as the one intended behavior improvement.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..engine import run_stage
from ..hostio import probe_video
from ..models import Task, TaskStatus
from ..ops.prepare import PreparedLut, prepare_lut
from ..plan import build_pipeline, build_render_spec
from .signals import Signal

_LUT_CACHE: Dict[Tuple[str, int], PreparedLut] = {}
_LUT_CACHE_LOCK = threading.Lock()
# A prepared LUT is its float32 table (0.4 MB at 33^3, 25 MB at 129^3); a
# warm daemon switching between a handful of looks shouldn't re-parse the
# .cube file on every task.
_LUT_CACHE_MAX = 4


def load_prepared_lut(path: Path) -> PreparedLut:
    """Parse + prebake a .cube, cached by (path, mtime); small LRU."""
    from ..colorcore import parse_cube_file

    path = Path(path)
    key = (str(path.resolve()), path.stat().st_mtime_ns)
    with _LUT_CACHE_LOCK:
        prep = _LUT_CACHE.pop(key, None)
        if prep is None:
            prep = prepare_lut(parse_cube_file(path))
            while len(_LUT_CACHE) >= _LUT_CACHE_MAX:
                _LUT_CACHE.pop(next(iter(_LUT_CACHE)))
        _LUT_CACHE[key] = prep  # (re-)insert at MRU position
        return prep


def extract_cover(source: Path, dest: Path) -> None:
    """First frame of `source` -> JPEG at `dest` (reference cover semantics:
    -frames:v 1 -q:v 2, task_manager.py:195-216)."""
    import cv2

    cap = cv2.VideoCapture(str(source))
    try:
        ok, frame = cap.read()
        if not ok or frame is None:
            raise RuntimeError(f"no frame decodable from {source}")
        if not cv2.imwrite(str(dest), frame, [cv2.IMWRITE_JPEG_QUALITY, 95]):
            raise RuntimeError(f"failed writing {dest}")
    finally:
        cap.release()


class TaskRunner:
    def __init__(self, task: Task, profile_dir=None):
        self.task = task
        self.profile_dir = profile_dir
        self.progress = Signal("progress")     # (task_id, int)
        self.status = Signal("status")         # (task_id, str)
        self.finished = Signal("finished")     # (task_id, str)
        self.log = Signal("log")               # (task_id, str)
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    # -----------------------------------------------------------------------
    def run(self) -> None:
        task = self.task
        self.status.emit(task.task_id, TaskStatus.RUNNING.value)
        self._log("started")
        task.started_at = time.time()
        stages = []

        try:
            stages = build_pipeline(task)
            if not stages:
                raise RuntimeError("no render stages built")

            for index, stage in enumerate(stages):
                if self._cancel.is_set():
                    break
                self._log(f"stage {index + 1}/{len(stages)}: {stage.name}")

                stage_info = task.source_info
                if stage.probe_source:
                    try:
                        stage_info = probe_video(stage.source_path)
                    except Exception as exc:
                        stage_info = None
                        self._log(
                            f"note: stage input probe failed (treating as "
                            f"unknown source): {exc}"
                        )

                spec = build_render_spec(
                    source=stage.source_path,
                    output=stage.output_path,
                    params=stage.params,
                    lut_path=stage.lut_path,
                    source_info=stage_info,
                    notes=stage.notes,
                )
                for note in stage.notes:
                    self._log(note)

                prep = None
                if spec.lut_path is not None:
                    prep = load_prepared_lut(spec.lut_path)
                    self._log(
                        f"LUT loaded: size {prep.size}^3"
                        + ("" if prep.has_unit_domain else " (non-unit domain)")
                    )

                progress_base = 0
                progress_span = 100
                if len(stages) > 1:
                    progress_span = 100 // len(stages)
                    progress_base = progress_span * index
                is_final = index == len(stages) - 1

                def stage_progress(p: int, base=progress_base,
                                   span=progress_span, final=is_final):
                    sp = int(p * span / 100)
                    if not final:
                        sp = min(sp, max(0, span - 1))
                    self.progress.emit(
                        task.task_id, min(base + sp, 100 if final else 99)
                    )

                result = run_stage(
                    spec,
                    stage_info,
                    prep,
                    progress_cb=stage_progress,
                    log_cb=lambda m: self._log(m),
                    cancel=self._cancel,
                    profile_dir=self.profile_dir,
                )
                # per-stage throughput counters (SURVEY §5.1) reach the task
                # log on EVERY outcome — the daemon status/TUI/web info views
                # all read this tail, so "which phase bounded this task" is
                # answerable from the task itself (reference analog: the
                # detail dialog's runtime info, main_window.py:1979-2119)
                if result.stats.frames_out or result.stats.frames_in:
                    self._log(f"stage {index + 1} stats: "
                              f"{result.stats.summary()}")
                if result.canceled:
                    break
                if not result.ok:
                    self.status.emit(
                        task.task_id, f"{TaskStatus.FAILED.value}: {result.error}"
                    )
                    self._log(f"failed: {result.error}")
                    self._cleanup_intermediates(stages, failed=True)
                    self.finished.emit(task.task_id, TaskStatus.FAILED.value)
                    return

            if self._cancel.is_set():
                self._cleanup_intermediates(stages, failed=True)
                self.status.emit(task.task_id, TaskStatus.CANCELED.value)
                self._log("canceled")
                self.finished.emit(task.task_id, TaskStatus.CANCELED.value)
                return

            if task.cover_path:
                self._log("extracting cover frame")
                src = (
                    task.output_path
                    if task.output_path.exists()
                    else task.source_path
                )
                try:
                    extract_cover(src, task.cover_path)
                    self._log(f"cover saved: {task.cover_path}")
                except Exception as exc:
                    self._log(f"cover extraction failed: {exc}")

            self._cleanup_intermediates(stages, failed=False)
            self.progress.emit(task.task_id, 100)
            self.status.emit(task.task_id, TaskStatus.COMPLETED.value)
            self._log(f"completed in {time.time() - task.started_at:.1f}s")
            self.finished.emit(task.task_id, TaskStatus.COMPLETED.value)

        except Exception as exc:
            self.status.emit(task.task_id, f"{TaskStatus.FAILED.value}: {exc}")
            self._log(f"failed: {exc}")
            # keep the no-leaked-master promise even when the failure is an
            # exception outside run_stage (e.g. spec/LUT loading for stage 2)
            self._cleanup_intermediates(stages, failed=True)
            self.finished.emit(task.task_id, TaskStatus.FAILED.value)

    def _cleanup_intermediates(self, stages, failed: bool) -> None:
        for stage in stages:
            if stage.cleanup_on_success and Path(stage.output_path).exists():
                try:
                    Path(stage.output_path).unlink()
                    if failed:
                        self._log(f"removed intermediate: {stage.output_path}")
                except Exception:
                    pass

    def _log(self, message: str) -> None:
        self.log.emit(self.task.task_id, message)
