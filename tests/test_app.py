"""app-layer tests: naming, presets, settings, history, estimates, defaults,
task factory, CLI parser."""

import json
from pathlib import Path

import numpy as np
import pytest

import lut_renderer_tpu.app.settings as settings_mod
from lut_renderer_tpu.app import (
    apply_smart_defaults,
    collect_video_files,
    cover_path_for,
    default_output_dir,
    estimate_prores_bytes,
    intermediate_path_for,
    load_settings,
    mode_template,
    output_path_for,
    save_settings,
)
from lut_renderer_tpu.app import lut_history as hist_list  # noqa: F401
from lut_renderer_tpu.app.cli import build_parser, main as cli_main
from lut_renderer_tpu.app.lut_history import cleanup_lut_history, last_lut, lut_history, remember_lut
from lut_renderer_tpu.app import presets as presets_mod
from lut_renderer_tpu.app.taskfactory import create_tasks
from lut_renderer_tpu.models import ProcessingParams, VideoInfo


@pytest.fixture(autouse=True)
def isolated_config(tmp_path, monkeypatch):
    monkeypatch.setattr(settings_mod, "_config_root", lambda: tmp_path / "cfg")
    yield


# ---- naming -----------------------------------------------------------------

def test_collect_video_files(tmp_path):
    (tmp_path / "a.mp4").touch()
    (tmp_path / "b.txt").touch()
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "c.MOV").touch()
    (sub / "d.webm").touch()
    files = collect_video_files([tmp_path, tmp_path / "a.mp4"])
    names = [f.name for f in files]
    assert "a.mp4" in names and "c.MOV" in names and "d.webm" in names
    assert "b.txt" not in names
    assert len(names) == len(set(names))  # deduped


def test_output_naming_collision(tmp_path):
    src = tmp_path / "clip.mp4"
    src.touch()
    out1 = output_path_for(src, tmp_path)
    assert out1.name == "clip_out.mp4"
    out1.touch()
    out2 = output_path_for(src, tmp_path)
    assert out2.name == "clip_out_1.mp4"
    out2.touch()
    assert output_path_for(src, tmp_path).name == "clip_out_2.mp4"


def test_cover_and_master_naming(tmp_path):
    src = tmp_path / "x.mov"
    assert cover_path_for(src, tmp_path).name == "x_cover.jpg"
    assert intermediate_path_for(src, tmp_path).name == "x_master.mov"


def test_default_output_dir(tmp_path):
    src = tmp_path / "v.mp4"
    out = default_output_dir(src)
    assert out == tmp_path / "output" and out.is_dir()


# ---- estimate ---------------------------------------------------------------

def test_prores_estimate_1080p30():
    info = VideoInfo(width=1920, height=1080, fps=29.97, duration=10.0)
    est = estimate_prores_bytes(info)
    assert abs(est - 220e6 / 8 * 10) / est < 0.01


def test_prores_estimate_floor():
    info = VideoInfo(width=64, height=64, fps=10, duration=10.0)
    est = estimate_prores_bytes(info)
    assert est == int(0.1 * 220e6 / 8 * 10)


def test_prores_estimate_no_duration():
    assert estimate_prores_bytes(VideoInfo(width=100, height=100)) is None


# ---- settings / presets / history ------------------------------------------

def test_settings_roundtrip_and_corrupt():
    save_settings({"ui_theme": "dark", "lut_history": ["/a"]})
    assert load_settings()["ui_theme"] == "dark"
    settings_mod.settings_path().write_text("{corrupt", encoding="utf-8")
    assert load_settings() == {}


def test_presets_lifecycle():
    p = ProcessingParams(bitrate="9M")
    presets_mod.save_preset("web", p)
    assert presets_mod.list_presets() == ["web"]
    assert presets_mod.load_preset("web").bitrate == "9M"
    with pytest.raises(FileExistsError):
        presets_mod.save_preset("web", p)
    presets_mod.overwrite_preset("web", ProcessingParams(bitrate="4M"))
    assert presets_mod.load_preset("web").bitrate == "4M"
    presets_mod.rename_preset("web", "tv")
    assert presets_mod.list_presets() == ["tv"]
    with pytest.raises(FileNotFoundError):
        presets_mod.load_preset("web")
    presets_mod.delete_preset("tv")
    assert presets_mod.list_presets() == []


def test_presets_load_all_skips_corrupt():
    presets_mod.save_preset("good", ProcessingParams())
    (presets_mod.presets_dir() / "bad.json").write_text("{", encoding="utf-8")
    all_p = presets_mod.load_all_presets()
    assert "good" in all_p and "bad" not in all_p


def test_lut_history(tmp_path):
    a = tmp_path / "a.cube"
    b = tmp_path / "b.cube"
    a.touch()
    b.touch()
    remember_lut(a)
    remember_lut(b)
    assert lut_history()[0] == str(b)
    remember_lut(a)  # moves to head
    assert lut_history()[0] == str(a) and len(lut_history()) == 2
    assert last_lut() == str(a)
    b.unlink()
    cleanup_lut_history()
    assert lut_history() == [str(a)]


# ---- defaults ---------------------------------------------------------------

def test_smart_defaults_fill_from_probe():
    info = VideoInfo(width=1920, height=1080, bitrate="8000k")
    p = apply_smart_defaults(ProcessingParams(video_codec="mpeg4"), info)
    assert p.resolution == "1920x1080" and p.bitrate == "8000k"


def test_smart_defaults_respect_explicit():
    info = VideoInfo(width=1920, height=1080, bitrate="8000k")
    p = apply_smart_defaults(
        ProcessingParams(video_codec="mpeg4", resolution="1280x720"), info
    )
    assert p.resolution == "1280x720"


def test_smart_defaults_copy_codec_untouched():
    info = VideoInfo(width=1920, height=1080, bitrate="8000k")
    p = apply_smart_defaults(ProcessingParams(video_codec="copy"), info)
    assert p.resolution == "" and p.bitrate == ""


def test_copy_plus_lut_autoswitch():
    p = apply_smart_defaults(
        ProcessingParams(video_codec="copy"), None, lut_active=True
    )
    assert p.video_codec != "copy"


def test_mode_templates():
    fast = mode_template("fast")
    pro = mode_template("pro")
    assert fast.processing_mode == "fast"
    assert pro.processing_mode == "pro" and pro.faststart
    assert fast.video_codec  # resolved to something available


# ---- task factory -----------------------------------------------------------

def _fake_probe(path):
    return VideoInfo(width=320, height=240, fps=25.0, duration=2.0,
                     bitrate="500k", pix_fmt="yuv420p", bit_depth=8)


def test_create_tasks_fast(tmp_path):
    src = tmp_path / "v.mp4"
    src.touch()
    batch = create_tasks([src], ProcessingParams(video_codec="mpeg4"),
                         probe_fn=_fake_probe)
    assert len(batch.tasks) == 1
    t = batch.tasks[0]
    assert t.output_path.parent == tmp_path / "output"
    assert t.params.resolution == "320x240"  # smart default applied
    assert t.intermediate_path is None


def test_create_tasks_pro_requires_master_dir(tmp_path):
    src = tmp_path / "v.mp4"
    src.touch()
    with pytest.raises(ValueError):
        create_tasks([src], ProcessingParams(processing_mode="pro"),
                     probe_fn=_fake_probe)


def test_create_tasks_pro(tmp_path):
    src = tmp_path / "v.mp4"
    src.touch()
    master = tmp_path / "masters"
    master.mkdir()
    batch = create_tasks(
        [src], ProcessingParams(processing_mode="pro", video_codec="mpeg4"),
        master_dir=master, probe_fn=_fake_probe,
    )
    t = batch.tasks[0]
    assert t.intermediate_path.name == "v_master.mov"
    assert any("estimated ProRes master" in m for m in batch.logs)


def test_create_tasks_none_found(tmp_path):
    batch = create_tasks([tmp_path], ProcessingParams(), probe_fn=_fake_probe)
    assert not batch.tasks and batch.warnings


# ---- CLI parser -------------------------------------------------------------

def test_cli_parser_render_flags():
    p = build_parser()
    args = p.parse_args([
        "render", "a.mp4", "--lut", "x.cube", "--mode", "pro",
        "--master-dir", "/tmp/m", "--bitrate", "10M", "--interp", "trilinear",
        "--bit-depth", "force_8bit", "--dither", "error_diffusion",
    ])
    assert args.command == "render" and args.mode == "pro"
    assert args.zscale_dither == "error_diffusion"


def test_cli_presets_roundtrip(capsys):
    rc = cli_main(["presets", "save", "x", "--params-json",
                   json.dumps({"bitrate": "3M"})])
    assert rc == 0
    rc = cli_main(["presets", "list"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "x" in out
    rc = cli_main(["presets", "show", "x"])
    assert "3M" in capsys.readouterr().out
    assert cli_main(["presets", "save", "x", "--params-json", "{}"]) == 2


def test_cli_encoders(capsys):
    assert cli_main(["encoders"]) == 0
    assert "prores_ks" in capsys.readouterr().out


def test_cli_dry_run(tmp_path, capsys):
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip
    from lut_renderer_tpu.colorcore import Lut3D, write_cube_file

    clip = make_gradient_clip(tmp_path / "d.mp4", 64, 64, frames=4)
    lut = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    rc = cli_main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--master-dir", str(tmp_path), "--dry-run"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stage 1: ProRes master" in out
    assert "stage 2: Distribution encode" in out
    assert "LUT output tags" in out
    assert not list(tmp_path.glob("output/*"))  # nothing executed


def test_cli_remembers_master_dir(tmp_path, capsys):
    """--master-dir persists as the `intermediate_dir` setting (reference
    stores the cache dir in settings); later pro runs reuse it."""
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip
    from lut_renderer_tpu.colorcore import Lut3D, write_cube_file

    clip = make_gradient_clip(tmp_path / "m.mp4", 64, 64, frames=4)
    lut = write_cube_file(tmp_path / "l.cube", Lut3D.identity(5))
    master = tmp_path / "masters"
    master.mkdir()
    rc = cli_main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--master-dir", str(master), "--dry-run"])
    assert rc == 0
    assert load_settings().get("intermediate_dir") == str(master)
    capsys.readouterr()
    # second run without the flag uses the remembered dir
    rc = cli_main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--dry-run"])
    assert rc == 0
    assert "using remembered master dir" in capsys.readouterr().out


def test_presets_name_validation_and_atomicity():
    import pytest as _pytest

    with _pytest.raises(presets_mod.PresetNameError):
        presets_mod.save_preset("../evil", ProcessingParams())
    with _pytest.raises(presets_mod.PresetNameError):
        presets_mod.load_preset("a/b")
    # atomic write leaves no temp droppings and the taxonomy maps to builtins
    presets_mod.save_preset("atomic", ProcessingParams(bitrate="2M"))
    leftovers = [p for p in presets_mod.presets_dir().iterdir()
                 if p.suffix == ".tmp"]
    assert not leftovers
    assert issubclass(presets_mod.PresetExistsError, FileExistsError)
    assert issubclass(presets_mod.PresetMissingError, FileNotFoundError)
    presets_mod.delete_preset("atomic")


def test_cli_help_topics(capsys):
    """`lut-tpu help` lists topics; each topic renders; aliases resolve;
    unknown topics fail with guidance (the reference's per-field help
    system, headless)."""
    from lut_renderer_tpu.app.help import TOPICS

    assert cli_main(["help"]) == 0
    listing = capsys.readouterr().out
    for name in TOPICS:
        assert name in listing
    assert cli_main(["help", "dither"]) == 0
    out = capsys.readouterr().out
    assert "Floyd-Steinberg" in out and "random" in out
    assert cli_main(["help", "bit-depth"]) == 0  # alias
    assert "force_8bit" in capsys.readouterr().out
    assert cli_main(["help", "nope"]) == 1


def test_help_covers_every_processing_param_field():
    """Full per-field help parity (VERDICT r2 #7): every ProcessingParams
    field name resolves to a real topic via help_text, as do the mode/
    concurrency/hardware topics of the reference's popup system."""
    import dataclasses

    from lut_renderer_tpu.app.help import help_text
    from lut_renderer_tpu.models import ProcessingParams

    for f in dataclasses.fields(ProcessingParams):
        if f.name.startswith("_"):
            continue
        text = help_text(f.name)
        assert "unknown topic" not in text, f.name
        assert len(text) > 120, (f.name, "topic too thin")
    for extra in ("mode", "concurrency", "hardware", "lut", "master_dir",
                  "out_dir", "watch", "queue", "naming", "precision"):
        assert "unknown topic" not in help_text(extra), extra


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["JAX_COMPILATION_CACHE_DIR", "in_checkout"])
def test_persistent_compile_cache_config(tmp_path, monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the code
    sets no directory; without it, the cache goes to one fixed path inside
    the checkout (listed in .gitignore). Enabling is idempotent."""
    import jax

    import lut_renderer_tpu.utils.compile_cache as cc

    repo = Path(__file__).resolve().parent.parent
    assert cc.DEFAULT_DIR == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
    updates = {}
    monkeypatch.setattr(cc, "_enabled", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "jc"))
        out = cc.enable_persistent_compile_cache()
        assert out == tmp_path / "jc"
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        monkeypatch.setattr(cc, "DEFAULT_DIR", tmp_path / "repo_cache")
        out = cc.enable_persistent_compile_cache()
        assert out == tmp_path / "repo_cache" and out.is_dir()
        assert updates["jax_compilation_cache_dir"] == str(out)
    assert cc.cache_dir() == out
    assert cc.enable_persistent_compile_cache() == out  # idempotent


def test_cli_luts_filter(tmp_path, capsys):
    from lut_renderer_tpu.app import remember_lut

    a = tmp_path / "warm_look.cube"
    b = tmp_path / "cool_look.cube"
    a.write_text("LUT_3D_SIZE 2\n" + "0 0 0\n" * 8)
    b.write_text("LUT_3D_SIZE 2\n" + "0 0 0\n" * 8)
    remember_lut(a)
    remember_lut(b)
    assert cli_main(["luts", "list", "--filter", "warm"]) == 0
    out = capsys.readouterr().out
    assert "warm_look" in out and "cool_look" not in out


def test_create_tasks_creates_master_dir(tmp_path, monkeypatch):
    """Pro mode with a not-yet-existing master dir creates it (the headless
    analog of the reference's directory picker)."""
    from pathlib import Path as _P

    from lut_renderer_tpu.app.taskfactory import create_tasks
    from lut_renderer_tpu.models import VideoInfo

    src = tmp_path / "a.mp4"
    src.write_bytes(b"x")
    master = tmp_path / "deep" / "masters"
    batch = create_tasks(
        [src], ProcessingParams(processing_mode="pro", video_codec="mpeg4"),
        out_dir=tmp_path / "out", master_dir=master,
        probe_fn=lambda p: VideoInfo(pix_fmt="yuv420p", bit_depth=8),
    )
    assert master.is_dir()
    assert batch.tasks and batch.tasks[0].intermediate_path.parent == master


def test_config_dir_env_override(tmp_path, monkeypatch):
    """LUT_TPU_CONFIG_DIR redirects ALL settings/history/preset persistence
    (conftest sets it so tests never touch the real user config dir)."""
    from lut_renderer_tpu.app import settings as settings_mod

    monkeypatch.setenv("LUT_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    assert settings_mod.settings_path() == tmp_path / "cfg" / "settings.json"
    settings_mod.save_settings({"k": 1})
    assert (tmp_path / "cfg" / "settings.json").exists()
    assert settings_mod.load_settings() == {"k": 1}


def test_icon_pngs(tmp_path, capsys):
    """Headless analog of the reference's procedural app icon
    (icon.py:16-29): same 7 sizes, RGBA, transparent corners, the indigo
    back-face grid present, deterministic output."""
    from lut_renderer_tpu.app.icon import ICON_SIZES, render_icon, write_icon_pngs

    assert ICON_SIZES == (16, 24, 32, 48, 64, 128, 256)
    paths = write_icon_pngs(tmp_path)
    assert [p.name for p in paths] == [f"lut-tpu_{s}.png" for s in ICON_SIZES]
    from PIL import Image

    for p, s in zip(paths, ICON_SIZES):
        arr = np.asarray(Image.open(p))
        assert arr.shape == (s, s, 4) and arr.dtype == np.uint8
    big = np.asarray(Image.open(paths[-1]))
    # corners transparent (rounded rect), center opaque
    assert big[0, 0, 3] == 0 and big[-1, -1, 3] == 0
    assert big[128, 128, 3] == 255
    # indigo back-face strokes present: pixels near (99, 102, 241)
    rgb = big[..., :3].astype(int)
    indigo = (abs(rgb - np.array([99, 102, 241])).sum(-1) < 120) & (big[..., 3] > 200)
    assert indigo.mean() > 0.01
    # deterministic
    assert np.array_equal(render_icon(64), render_icon(64))
    # CLI surface
    rc = cli_main(["icon", "--out", str(tmp_path / "cli")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "lut-tpu_256.png" in out
    assert (tmp_path / "cli" / "lut-tpu_16.png").exists()
