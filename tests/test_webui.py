"""Web GUI tests: the HTTP shell over the serve daemon (app/webui.py).

The page + JSON API are the browser analog of the reference's Qt main
window (SURVEY §2.2 "Qt/PySide6 GUI shell"); these drive the API end to
end — submit through render to completion, presets with the overwrite
contract, LUT-history side effects, thumbnails, and transport errors.
"""

import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from lut_renderer_tpu.app.server import QueueServer
from lut_renderer_tpu.app.webui import WebUI
from lut_renderer_tpu.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu.utils.fixtures import make_gradient_clip


@pytest.fixture()
def web(tmp_path):
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=6)
    cube = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    server = QueueServer(tmp_path / "unused.sock", max_concurrency=2)
    ui = WebUI(server, port=0, settings={})
    ui.start()
    yield ui, clip, cube, tmp_path
    ui.stop()


def _get(ui, path, raw=False):
    with urllib.request.urlopen(ui.url.rstrip("/") + path, timeout=30) as r:
        body = r.read()
        return (r.headers.get("Content-Type"), body) if raw \
            else json.loads(body)


def _op(ui, req):
    data = json.dumps(req).encode()
    http_req = urllib.request.Request(
        ui.url.rstrip("/") + "/api/op", data=data,
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(http_req, timeout=30) as r:
        return json.loads(r.read())


def _wait_done(ui, task_ids, timeout=240):
    deadline = time.time() + timeout
    while time.time() < deadline:
        q = _get(ui, "/api/queue")
        assert q["ok"]
        by_id = {t["task_id"]: t for t in q["tasks"]}
        if {by_id[t]["status"] for t in task_ids} <= {
                "completed", "failed", "canceled"}:
            return by_id
        time.sleep(0.1)
    raise AssertionError("queue did not drain")


def test_index_page_and_meta(web):
    ui, clip, cube, tmp = web
    ctype, body = _get(ui, "/", raw=True)
    assert ctype.startswith("text/html")
    page = body.decode()
    assert "LUT Renderer" in page and "/api/op" in page
    meta = _get(ui, "/api/meta")
    assert meta["ok"] and meta["concurrency"] == 2
    fields = {f["name"]: f for f in meta["fields"]}
    # the full ProcessingParams namespace is exposed, with per-field help
    # (the reference's popup text) and both mode-template defaults
    assert "video_codec" in fields and fields["video_codec"]["help"]
    assert fields["faststart"]["bool"] is True
    assert fields["processing_mode"]["pro"] == "pro"
    assert fields["video_codec"]["fast"] != "libx264"  # available encoder


def test_submit_render_info_thumb_and_lut_history(web):
    ui, clip, cube, tmp = web
    resp = _op(ui, {"op": "submit", "files": [str(clip)], "lut": str(cube),
                    "params": {"video_codec": "mpeg4", "bitrate": "1M"},
                    "out_dir": str(tmp / "out")})
    assert resp["ok"], resp
    (tid,) = resp["task_ids"]
    by_id = _wait_done(ui, [tid])
    assert by_id[tid]["status"] == "completed"
    assert Path(by_id[tid]["output"]).exists()
    # the info view carries the runtime log tail (the reference's detail
    # dialog content)
    one = _get(ui, f"/api/task?id={tid}")
    assert one["ok"] and one["task"]["progress"] == 100
    assert any("engine:" in m for m in one["task"]["logs"])
    # per-stage throughput counters land in the task log (SURVEY §5.1):
    # decode/render/encode fps readable off the task itself
    (stats_line,) = [m for m in one["task"]["logs"] if "stats:" in m]
    assert "render" in stats_line and "encode" in stats_line
    # the probe detail the reference's info dialog shows
    si = one["task"]["source_info"]
    assert si["width"] == 64 and si["height"] == 64 and si["codec_name"]
    # submitting with a LUT remembers it, exactly like Start
    assert str(cube) in _get(ui, "/api/meta")["luts"]
    # queue-table thumbnail for the task's source
    ctype, body = _get(ui, f"/api/thumb?task={tid}", raw=True)
    assert ctype.startswith("image/") and len(body) > 100
    # output download (the web analog of the per-row open-output button)
    ctype, body = _get(ui, f"/api/file?task={tid}", raw=True)
    assert body == Path(by_id[tid]["output"]).read_bytes()
    assert ctype.startswith("video/")
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(ui, f"/api/file?task={tid}&kind=cover")  # no cover requested
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(ui, f"/api/file?task={tid}&kind=../etc")  # only known kinds
    assert err.value.code == 404
    # reprocess through the same passthrough op the socket uses
    rep = _op(ui, {"op": "reprocess", "task_id": tid,
                   "params": {"lut_interp": "trilinear"}})
    assert rep["ok"], rep
    second = _wait_done(ui, [tid])[tid]
    assert second["status"] == "completed"
    assert second["output"] != by_id[tid]["output"]
    cleared = _op(ui, {"op": "clear"})
    assert cleared["ok"] and cleared["removed"] == 1


def test_live_concurrency_config(web):
    """The reference's concurrency spinner applies live (main_window.py:
    856-860, range 1-16); the config op is its daemon/web analog."""
    ui, clip, cube, tmp = web
    r = _op(ui, {"op": "config", "concurrency": 5})
    assert r["ok"] and r["concurrency"] == 5
    assert ui.queue.manager.max_concurrency == 5
    assert _get(ui, "/api/meta")["concurrency"] == 5
    # clamps to the spinner range, rejects non-integers
    assert _op(ui, {"op": "config", "concurrency": 99})["concurrency"] == 16
    assert _op(ui, {"op": "config", "concurrency": 0})["concurrency"] == 1
    assert not _op(ui, {"op": "config", "concurrency": "many"})["ok"]
    # config with nothing to set is a no-op report
    assert _op(ui, {"op": "config"})["concurrency"] == 1


def test_ui_theme_persisted(web):
    """Dark/light theme stored under the reference's own ui_theme settings
    key, with the reference's fresh-install default of light
    (reference app.py:79, main_window.py:207)."""
    ui, clip, cube, tmp = web
    assert _get(ui, "/api/meta")["ui_theme"] == "light"
    assert _op(ui, {"op": "ui_theme", "theme": "dark"})["ok"]
    assert _get(ui, "/api/meta")["ui_theme"] == "dark"
    assert ui.settings["ui_theme"] == "dark"
    assert not _op(ui, {"op": "ui_theme", "theme": "solarized"})["ok"]


def test_preset_save_load_overwrite_contract(web):
    ui, clip, cube, tmp = web
    params = {"video_codec": "mpeg4", "bitrate": "3M", "faststart": True}
    assert _op(ui, {"op": "save_preset", "name": "webp",
                    "params": params})["ok"]
    assert "webp" in _get(ui, "/api/meta")["presets"]
    # second save without overwrite follows the FileExistsError contract
    again = _op(ui, {"op": "save_preset", "name": "webp", "params": params})
    assert not again["ok"] and again["error"] == "exists"
    params["bitrate"] = "4M"
    assert _op(ui, {"op": "save_preset", "name": "webp", "params": params,
                    "overwrite": True})["ok"]
    loaded = _get(ui, "/api/preset?name=webp")
    assert loaded["ok"] and loaded["params"]["bitrate"] == "4M"
    assert loaded["params"]["faststart"] is True
    assert not _get(ui, "/api/preset?name=ghost")["ok"]
    # rename keeps the FileExistsError contract; delete removes
    assert _op(ui, {"op": "rename_preset", "name": "webp",
                    "new_name": "webq"})["ok"]
    assert not _op(ui, {"op": "rename_preset", "name": "missing",
                        "new_name": "x"})["ok"]
    deleted = _op(ui, {"op": "delete_preset", "name": "webq"})
    assert deleted["ok"] and "webq" not in deleted["presets"]


def test_lut_manager_ops(web):
    """The LutManagerDialog analog (reference lut_manager.py:26-186):
    browser upload (parse-validated, anti-collision, traversal-proof),
    set-current moves to head, clean drops vanished files."""
    ui, clip, cube, tmp = web
    text = Path(cube).read_text()
    r = _op(ui, {"op": "upload_lut", "name": "look.cube", "text": text})
    assert r["ok"] and r["path"].endswith("look.cube"), r
    assert r["size"] == 5
    assert Path(r["path"]).read_text() == text
    # collision gets a counter suffix unless overwrite is set
    r2 = _op(ui, {"op": "upload_lut", "name": "look.cube", "text": text})
    assert r2["ok"] and r2["path"].endswith("look_1.cube")
    r3 = _op(ui, {"op": "upload_lut", "name": "look.cube", "text": text,
                  "overwrite": True})
    assert r3["ok"] and r3["path"] == r["path"]
    # names reduce to their basename (no directory traversal)
    evil = _op(ui, {"op": "upload_lut", "name": "../../evil.cube",
                    "text": text})
    assert evil["ok"] and "/luts/evil.cube" in evil["path"]
    # invalid name / unparseable content are rejected before any write
    assert not _op(ui, {"op": "upload_lut", "name": "x.txt",
                        "text": text})["ok"]
    assert not _op(ui, {"op": "upload_lut", "name": "bad.cube",
                        "text": "LUT_3D_SIZE 2\n0 0 0"})["ok"]
    # history view: newest upload at the head, existence flags
    view = _op(ui, {"op": "luts"})
    assert view["ok"] and view["luts"][0]["path"] == evil["path"]
    assert all(l["exists"] for l in view["luts"])
    # set-current moves an existing path to the head; missing is an error
    assert _op(ui, {"op": "select_lut", "path": str(cube)})["ok"]
    assert _op(ui, {"op": "luts"})["luts"][0]["path"] == str(cube)
    assert not _op(ui, {"op": "select_lut", "path": "/missing.cube"})["ok"]
    # clean drops entries whose files no longer exist
    gone = _op(ui, {"op": "upload_lut", "name": "gone.cube", "text": text})
    Path(gone["path"]).unlink()
    cleaned = _op(ui, {"op": "clean_luts"})
    assert cleaned["ok"] and cleaned["removed"] == 1
    assert all(l["exists"] for l in cleaned["luts"])
    # an uploaded LUT renders end-to-end
    resp = _op(ui, {"op": "submit", "files": [str(clip)],
                    "lut": r3["path"],
                    "params": {"video_codec": "mpeg4", "bitrate": "1M"},
                    "out_dir": str(tmp / "outu")})
    assert resp["ok"], resp
    done = _wait_done(ui, resp["task_ids"])
    assert all(t["status"] == "completed" for t in done.values())


def test_page_script_consistency():
    """No JS engine exists in this environment, so pin the failure class
    that would silently kill the page: every DOM id the script references
    must exist in the markup, every API path it fetches must be a served
    route, and the script's delimiters must balance (template literals
    excluded from the scan)."""
    import re

    from lut_renderer_tpu.app.webui_page import PAGE

    markup, script = PAGE.split("<script>", 1)
    script = script.split("</script>", 1)[0]
    dom_ids = set(re.findall(r'id="([\w-]+)"', markup))
    for ref in re.findall(r'\$\("([\w-]+)"\)', script):
        assert ref in dom_ids, f"script references missing element #{ref}"
    served = {"/api/meta", "/api/queue", "/api/task", "/api/preset",
              "/api/thumb", "/api/file", "/api/op"}
    for path in re.findall(r'"(/api/[\w/]*)', script):
        assert path in served, f"script fetches unserved route {path}"
    # dynamic ids built as "p_" + field must match the inputs buildForm makes
    assert '"p_" + f.name' in script
    # delimiter balance over the code outside string/template literals
    # (small state machine: the page avoids JS regex literals and nested
    # template literals so this scan stays exact)
    assert "replaceAll" in script  # esc() must not use a regex literal
    code, i, state, depth = [], 0, "code", 0
    while i < len(script):
        c = script[i]
        if state in ("'", '"', "`"):
            if c == "\\":
                i += 2
                continue
            if state == "`" and c == "$" and script[i + 1:i + 2] == "{":
                state, depth = "interp", 1
                i += 2
                continue
            if c == state:
                state = "code"
        elif state == "interp":
            assert c not in "'\"`", "string literal inside ${} unsupported"
            depth += c == "{"
            depth -= c == "}"
            if depth == 0:
                state = "`"
            else:
                code.append(c)
        else:
            if c in "'\"`":
                state = c
            else:
                code.append(c)
        i += 1
    assert state == "code", f"unterminated {state} literal"
    stripped = "".join(code)
    for o, c in ("()", "[]", "{}"):
        assert stripped.count(o) == stripped.count(c), f"unbalanced {o}{c}"


def test_transport_and_protocol_errors(web):
    ui, clip, cube, tmp = web
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(ui, "/nope")
    assert err.value.code == 404
    bad = urllib.request.Request(
        ui.url.rstrip("/") + "/api/op", data=b"{bad json",
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(bad, timeout=30)
    assert err.value.code == 400
    assert "bad json" in json.loads(err.value.read())["error"]
    # protocol-level errors are 200 + ok:false (same as the socket)
    assert not _op(ui, {"op": "nope"})["ok"]
    assert not _op(ui, {"op": "submit", "files": []})["ok"]
    assert not _get(ui, "/api/task?id=ghost")["ok"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(ui, "/api/thumb?task=ghost")
    assert err.value.code == 404


def _status_of(request_obj):
    try:
        with urllib.request.urlopen(request_obj, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as err:
        return err.code


def test_csrf_protections(web):
    """The HTTP port is reachable from any page the browser visits (unlike
    the Unix socket), so state-changing POSTs are gated: JSON content type
    required (a browser can't send it cross-origin without a CORS
    preflight), cross-site Origin rejected, and a wrong Host header
    (DNS rebinding against the loopback bind) rejected everywhere."""
    base = web[0].url.rstrip("/")
    body = json.dumps({"op": "clear"}).encode()
    # no-cors CSRF shape: form content type
    form = urllib.request.Request(
        base + "/api/op", data=body, method="POST",
        headers={"Content-Type": "text/plain"})
    assert _status_of(form) == 415
    # explicit cross-origin post
    xorigin = urllib.request.Request(
        base + "/api/op", data=body, method="POST",
        headers={"Content-Type": "application/json",
                 "Origin": "https://evil.example"})
    assert _status_of(xorigin) == 403
    # same-origin posts keep working
    sameorigin = urllib.request.Request(
        base + "/api/op", data=body, method="POST",
        headers={"Content-Type": "application/json",
                 "Origin": f"http://127.0.0.1:{web[0].port}"})
    assert _status_of(sameorigin) == 200
    # DNS rebinding: attacker's hostname resolving to 127.0.0.1
    rebind = urllib.request.Request(
        base + "/api/meta", headers={"Host": "evil.example"})
    assert _status_of(rebind) == 403


def test_token_auth(tmp_path):
    """`serve --http-token`: every endpoint requires the token, supplied as
    ?token= (persisted into a SameSite cookie so <a download> links work)
    or X-Auth-Token; non-loopback binds refuse to start without one."""
    server = QueueServer(tmp_path / "t.sock")
    ui = WebUI(server, port=0, settings={}, token="sekrit")
    ui.start()
    try:
        base = ui.url.rstrip("/")
        assert _status_of(urllib.request.Request(base + "/api/meta")) == 401
        with urllib.request.urlopen(base + "/?token=sekrit",
                                    timeout=30) as r:
            assert r.status == 200
            cookie = r.headers.get("Set-Cookie", "")
            assert "luttok=sekrit" in cookie and "SameSite=Strict" in cookie
        # header auth and cookie auth both work on the API
        hdr = urllib.request.Request(base + "/api/meta",
                                     headers={"X-Auth-Token": "sekrit"})
        with urllib.request.urlopen(hdr, timeout=30) as r:
            assert json.loads(r.read())["ok"]
        ck = urllib.request.Request(base + "/api/meta",
                                    headers={"Cookie": "luttok=sekrit"})
        with urllib.request.urlopen(ck, timeout=30) as r:
            assert json.loads(r.read())["ok"]
        wrong = urllib.request.Request(base + "/api/meta",
                                       headers={"X-Auth-Token": "nope"})
        assert _status_of(wrong) == 401
        # authed POST works end to end
        post = urllib.request.Request(
            base + "/api/op", data=json.dumps({"op": "clear"}).encode(),
            method="POST", headers={"Content-Type": "application/json",
                                    "X-Auth-Token": "sekrit"})
        with urllib.request.urlopen(post, timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        ui.stop()
    # non-loopback bind without a token refuses to construct
    with pytest.raises(ValueError, match="http-token"):
        WebUI(server, host="0.0.0.0", port=0, settings={})


def test_origin_gate_uses_reached_host_not_bind_address(tmp_path):
    """Same-origin means the host the CLIENT reached (its Host header),
    not the bind address: a 0.0.0.0-bound daemon browsed via a LAN name
    must accept the page's own fetches and still reject cross-site
    Origins (round-5 code-review catch — comparing against the literal
    bind address 403'd every legitimate POST)."""
    server = QueueServer(tmp_path / "o.sock")
    ui = WebUI(server, host="0.0.0.0", port=0, settings={}, token="tk")
    ui.start()
    try:
        base = f"http://127.0.0.1:{ui.port}"
        body = json.dumps({"op": "clear"}).encode()
        same = urllib.request.Request(
            base + "/api/op", data=body, method="POST",
            headers={"X-Auth-Token": "tk",
                     "Content-Type": "application/json",
                     "Host": "render-box.lan:8080",
                     "Origin": "http://render-box.lan:8080"})
        assert _status_of(same) == 200
        cross = urllib.request.Request(
            base + "/api/op", data=body, method="POST",
            headers={"X-Auth-Token": "tk",
                     "Content-Type": "application/json",
                     "Host": "render-box.lan:8080",
                     "Origin": "https://evil.example"})
        assert _status_of(cross) == 403
    finally:
        ui.stop()


def test_web_shutdown_is_deterministic(tmp_path):
    """The shutdown reply is flushed BEFORE the signal fires (no wall-clock
    grace timer): by the time the client has the response, the daemon's
    shutdown event is set and new submits are refused."""
    server = QueueServer(tmp_path / "s.sock")
    ui = WebUI(server, port=0, settings={})
    ui.start()
    try:
        r = _op(ui, {"op": "shutdown"})
        assert r["ok"] and "_then_shutdown" not in r
        assert server.shutdown_requested.wait(5)
        assert not server.handle_request({"op": "submit",
                                          "files": ["/x.mp4"]})["ok"]
    finally:
        ui.stop()


def test_page_reads_only_live_api_fields(web):
    """Field-level page contract: every JSON field the page's JS reads off
    an API response object must exist in the corresponding LIVE response
    (no JS engine exists here, so renaming a server-side field must break
    this test before it breaks the page). Receivers are extracted
    mechanically from the script: `m.` (meta), `q.` (queue), `t.` (task
    views), `l.` (LUT entries), `f.` (field schema) and `r.` (op
    responses); method calls are skipped."""
    import re

    from lut_renderer_tpu.app.webui_page import PAGE

    ui, clip, cube, tmp = web

    # ---- live responses covering every shape the page touches ----
    meta = _get(ui, "/api/meta")
    submit = _op(ui, {"op": "submit", "files": [str(clip)],
                      "lut": str(cube),
                      "params": {"video_codec": "mpeg4", "bitrate": "1M"},
                      "out_dir": str(tmp / "outf")})
    assert submit["ok"], submit
    (tid,) = submit["task_ids"]
    queue = _get(ui, "/api/queue")
    _wait_done(ui, [tid])
    task = _get(ui, f"/api/task?id={tid}")
    luts = _op(ui, {"op": "luts"})
    upload = _op(ui, {"op": "upload_lut", "name": "contract.cube",
                      "text": Path(cube).read_text()})
    preset = _op(ui, {"op": "save_preset", "name": "contract",
                      "params": {"video_codec": "mpeg4"}})
    loaded = _get(ui, "/api/preset?name=contract")
    config = _op(ui, {"op": "config", "concurrency": 2})
    clear = _op(ui, {"op": "clear"})
    exists_err = _op(ui, {"op": "save_preset", "name": "contract",
                          "params": {}})  # ok:false + error shape

    task_fields = (set(queue["tasks"][0]) | set(task["task"])
                   | {"logs", "source_info"})
    op_fields = (set(submit) | set(luts) | set(upload) | set(preset)
                 | set(loaded) | set(config) | set(clear) | set(exists_err)
                 | set(task) | {"error", "warnings", "logs"})
    live = {
        "m": set(meta),
        "q": set(queue),
        "t": task_fields,
        "l": set(luts["luts"][0]),
        "f": {f for fld in meta["fields"] for f in fld},
        "r": op_fields,
    }

    script = PAGE.split("<script>", 1)[1].split("</script>", 1)[0]
    checked = 0
    for recv, field, call in re.findall(
            r"\b([mqtlfr])\.([A-Za-z_]\w*)(\()?", script):
        if call:  # method call (r.json(), f.text(), l.path.toLowerCase()…)
            continue
        assert field in live[recv], \
            f"page reads {recv}.{field} but the live response lacks it"
        checked += 1
    assert checked >= 30  # the extraction actually found the reads
