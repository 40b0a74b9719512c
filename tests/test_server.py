"""Warm render daemon tests: protocol, job lifecycle, warm reuse, shutdown."""

import json
import time
from pathlib import Path

import pytest

from lut_renderer_tpu.app.server import QueueServer, request
from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.utils.fixtures import make_gradient_clip


@pytest.fixture()
def served(tmp_path):
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=6)
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    sock = tmp_path / "lut.sock"
    server = QueueServer(sock, max_concurrency=2)
    server.start()
    yield server, sock, clip, cube, tmp_path
    server.stop()


def _wait_done(sock, task_ids, timeout=240):
    deadline = time.time() + timeout
    while time.time() < deadline:
        resp = request(sock, {"op": "status"})
        assert resp["ok"]
        by_id = {t["task_id"]: t for t in resp["tasks"]}
        states = {by_id[t]["status"] for t in task_ids}
        if states <= {"completed", "failed", "canceled"}:
            return by_id
        time.sleep(0.1)
    raise AssertionError("queue did not drain")


def test_serve_submit_status_complete(served):
    server, sock, clip, cube, tmp = served
    assert request(sock, {"op": "ping"}) == {"ok": True, "tasks": 0}
    resp = request(sock, {
        "op": "submit",
        "files": [str(clip)],
        "lut": str(cube),
        "params": {"video_codec": "mpeg4", "bitrate": "1M"},
        "out_dir": str(tmp / "out"),
    })
    assert resp["ok"], resp
    (tid,) = resp["task_ids"]
    by_id = _wait_done(sock, [tid])
    assert by_id[tid]["status"] == "completed"
    assert Path(by_id[tid]["output"]).exists()
    one = request(sock, {"op": "status", "task_id": tid})
    assert one["ok"] and one["task"]["progress"] == 100
    # the single-task view exposes the runtime log tail (policy decision
    # notes + stage lines — what the CLI prints); round-4 serving parity
    # with the reference's task detail dialog
    logs = one["task"]["logs"]
    assert any("engine:" in m for m in logs), logs
    assert any("note:" in m.lower() or "Auto GOP" in m for m in logs), logs

    # warm reuse: a second job on the same server/process completes too
    resp2 = request(sock, {
        "op": "submit",
        "files": [str(clip)],
        "lut": str(cube),
        "params": {"video_codec": "mpeg4", "bitrate": "1M"},
        "out_dir": str(tmp / "out2"),
    })
    assert resp2["ok"]
    by_id2 = _wait_done(sock, resp2["task_ids"])
    assert all(t["status"] == "completed" for t in by_id2.values()
               if t["task_id"] in resp2["task_ids"])


def test_serve_errors_and_cancel(served):
    server, sock, clip, cube, tmp = served
    assert not request(sock, {"op": "nope"})["ok"]
    assert not request(sock, {"op": "submit", "files": []})["ok"]
    assert not request(sock, {"op": "submit", "files": [str(clip)],
                              "lut": "/missing.cube"})["ok"]
    assert not request(sock, {"op": "cancel", "task_id": "ghost"})["ok"]
    assert not request(sock, {"op": "status", "task_id": "ghost"})["ok"]
    # malformed JSON produces an error response, not a dropped connection
    import socket as socketlib

    with socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM) as s:
        s.connect(str(sock))
        s.sendall(b"{bad json\n")
        line = s.makefile().readline()
    assert "bad json" in json.loads(line)["error"]


def test_serve_shutdown_cancels_and_refuses(served):
    server, sock, clip, cube, tmp = served
    resp = request(sock, {"op": "shutdown"})
    assert resp["ok"]
    assert "_then_shutdown" not in resp  # transport strips the marker
    # the reply is flushed BEFORE the signal (deterministic — no grace
    # timer), so by the time the client has the response the server is
    # already stopping: new connections are refused, and direct submits
    # through the API are refused by the drain flag
    assert server.shutdown_requested.wait(5)
    assert not server.handle_request(
        {"op": "submit", "files": [str(clip)]})["ok"]
    server.wait()  # returns: queue drained


def test_serve_clear_completed(served):
    server, sock, clip, cube, tmp = served
    resp = request(sock, {
        "op": "submit", "files": [str(clip)], "lut": str(cube),
        "params": {"video_codec": "mpeg4", "bitrate": "1M"},
        "out_dir": str(tmp / "outc"),
    })
    assert resp["ok"]
    _wait_done(sock, resp["task_ids"])
    cleared = request(sock, {"op": "clear"})
    assert cleared["ok"] and cleared["removed"] == 1
    assert request(sock, {"op": "status"})["tasks"] == []


def test_serve_reprocess(served):
    server, sock, clip, cube, tmp = served
    resp = request(sock, {
        "op": "submit", "files": [str(clip)], "lut": str(cube),
        "params": {"video_codec": "mpeg4", "bitrate": "1M"},
        "out_dir": str(tmp / "outr"),
    })
    (tid,) = resp["task_ids"]
    first = _wait_done(sock, [tid])[tid]
    assert first["status"] == "completed"
    rep = request(sock, {"op": "reprocess", "task_id": tid,
                         "params": {"video_codec": "mpeg4", "bitrate": "2M"}})
    assert rep["ok"], rep
    second = _wait_done(sock, [tid])[tid]
    assert second["status"] == "completed"
    assert second["output"] != first["output"]   # fresh anti-collision name
    assert Path(second["output"]).exists()
    assert not request(sock, {"op": "reprocess", "task_id": "ghost"})["ok"]


def test_serve_reprocess_partial_params_inherit(served):
    """Reprocess params are a PARTIAL overlay on the task's current params:
    a request changing only `lut_interp` must keep the resolved codec (the bare
    dataclass default is libx264, absent from the bundled libavcodec —
    caught live-driving serve: the reprocessed task failed at encode open)."""
    server, sock, clip, cube, tmp = served
    resp = request(sock, {
        "op": "submit", "files": [str(clip)], "lut": str(cube),
        "out_dir": str(tmp / "outp"),
    })
    (tid,) = resp["task_ids"]
    assert _wait_done(sock, [tid])[tid]["status"] == "completed"
    codec = server.manager.tasks[tid].params.video_codec
    assert codec != "libx264"
    rep = request(sock, {"op": "reprocess", "task_id": tid,
                         "params": {"lut_interp": "trilinear"}})
    assert rep["ok"], rep
    assert server.manager.tasks[tid].params.video_codec == codec
    assert server.manager.tasks[tid].params.lut_interp == "trilinear"
    second = _wait_done(sock, [tid])[tid]
    assert second["status"] == "completed", second
    assert not request(sock, {"op": "reprocess", "task_id": "missing",
                              "params": {"lut_interp": "trilinear"}})["ok"]


def test_serve_concurrent_clients(served):
    """Several clients hammering status/ping concurrently get coherent
    responses (threaded handler, shared manager)."""
    import threading

    server, sock, clip, cube, tmp = served
    errors = []

    def worker(i):
        try:
            for _ in range(20):
                assert request(sock, {"op": "ping"})["ok"]
                assert request(sock, {"op": "status"})["ok"]
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors


def test_serve_queue_file_restart_recovery(tmp_path):
    """serve --queue-file: every state change persists atomically, and a
    restarted daemon resumes interrupted (RUNNING) tasks to completion —
    the serving-deployment recovery affordance (SURVEY §5.4; the
    reference's in-memory queue dies with the app)."""
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, frames=4)
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    qf = tmp_path / "queue.json"
    sock = tmp_path / "a.sock"
    server = QueueServer(sock, max_concurrency=1,
                         queue_file=qf)
    server.start()
    resp = request(sock, {"op": "submit", "files": [str(clip)],
                          "lut": str(cube),
                          "params": {"video_codec": "mpeg4",
                                     "bitrate": "1M"},
                          "out_dir": str(tmp_path / "out")})
    assert resp["ok"], resp
    (tid,) = resp["task_ids"]
    _wait_done(sock, [tid])
    server.stop()
    saved = json.loads(qf.read_text())
    assert saved["tasks"][0]["status"] == "completed"
    # simulate a crash mid-run: the persisted state says RUNNING
    saved["tasks"][0]["status"] = "running"
    saved["tasks"][0]["progress"] = 37
    qf.write_text(json.dumps(saved))
    sock2 = tmp_path / "b.sock"
    server2 = QueueServer(sock2, max_concurrency=1,
                          queue_file=qf)
    server2.start()
    try:
        assert not server2.restore_error
        by_id = _wait_done(sock2, [tid])
        assert by_id[tid]["status"] == "completed"  # auto-resumed
        assert json.loads(qf.read_text())["tasks"][0]["status"] == "completed"
    finally:
        server2.stop()


def test_serve_queue_file_corrupt_preserved(tmp_path):
    """An unreadable queue file is reported on ping and moved aside
    (.corrupt) so the daemon's fresh persists cannot destroy evidence."""
    qf = tmp_path / "queue.json"
    qf.write_text("{broken")
    server = QueueServer(tmp_path / "c.sock",
                         queue_file=qf)
    server.start()
    try:
        resp = request(tmp_path / "c.sock", {"op": "ping"})
        assert "restore failed" in resp.get("restore_error", "")
        assert (tmp_path / "queue.json.corrupt").read_text() == "{broken"
        assert not qf.exists()
    finally:
        server.stop()


def test_submit_without_codec_gets_available_encoder(tmp_path):
    """A submit that names no codec must resolve to the mode template's
    first AVAILABLE encoder, exactly like the CLI — the bare dataclass
    default (libx264) is not in the bundled libavcodec and would fail at
    encode open (caught live driving serve on this box)."""
    from lut_renderer_tpu.app.defaults import mode_template

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, frames=3)
    server = QueueServer(tmp_path / "s.sock", max_concurrency=1)
    server.manager.start_all = lambda: None  # inspect params, don't render
    resp = server._submit({"files": [str(clip)],
                           "out_dir": str(tmp_path / "out")})
    assert resp["ok"], resp
    task = next(iter(server.manager.tasks.values()))
    expect = mode_template("fast").video_codec
    assert task.params.video_codec == expect
    assert task.params.video_codec != "copy"
