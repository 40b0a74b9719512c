"""Engine tests: config derivation, frame scheduler, end-to-end stage runs
on the CPU backend.
"""

import threading
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.colorcore import Lut3D, parse_cube_file, write_cube_file
from lut_renderer_tpu.engine import FrameScheduler, run_stage
from lut_renderer_tpu.engine.config import (
    derive_render_config,
    derive_encoder_settings,
    effective_output_pix_fmt,
    output_fps,
    parse_pix_fmt,
    parse_resolution,
)
from lut_renderer_tpu.hostio import probe_video, VideoDecoder
from lut_renderer_tpu.hostio.decode import DecodedFrame
from lut_renderer_tpu.models import ProcessingParams, VideoInfo
from lut_renderer_tpu.ops import prepare_lut
from lut_renderer_tpu.plan import build_render_spec
from lut_renderer_tpu.utils.fixtures import make_gradient_clip

SRC = Path("/in/a.mov")
OUT = Path("/out/a.mp4")
LUT = Path("/l.cube")


# ---- config derivation ------------------------------------------------------

def test_parse_pix_fmt():
    assert parse_pix_fmt("yuv420p") == (8, "420")
    assert parse_pix_fmt("yuv422p10le") == (10, "422")
    assert parse_pix_fmt("yuv444p") == (8, "444")
    assert parse_pix_fmt(None) == (8, "420")


def test_parse_resolution():
    assert parse_resolution("1920x1080") == (1920, 1080)
    assert parse_resolution("1280*720") == (1280, 720)
    assert parse_resolution("") is None
    assert parse_resolution("junk") is None


def test_render_config_from_yuvj_source():
    info = VideoInfo(pix_fmt="yuvj420p", bit_depth=8, colorspace="smpte170m")
    spec = build_render_spec(SRC, OUT, ProcessingParams(), LUT, info)
    cfg = derive_render_config(spec, info)
    assert cfg.in_full_range and not cfg.work_full_range
    assert cfg.matrix_in == "smpte170m"
    assert cfg.matrix_out == "bt709"  # LUT output tags bt709
    assert not cfg.out_full_range
    assert cfg.apply_lut


def test_render_config_10bit_preserve():
    info = VideoInfo(pix_fmt="yuv422p10le", bit_depth=10)
    spec = build_render_spec(
        SRC, OUT, ProcessingParams(video_codec="prores_ks"), LUT, info
    )
    cfg = derive_render_config(spec, info)
    assert cfg.in_depth == 10 and cfg.out_depth == 10
    assert cfg.out_subsampling == "422"


def test_render_config_dither():
    info = VideoInfo(pix_fmt="yuv420p10le", bit_depth=10)
    spec = build_render_spec(
        SRC, OUT,
        ProcessingParams(bit_depth_policy="force_8bit", zscale_dither="error_diffusion"),
        LUT, info,
    )
    cfg = derive_render_config(spec, info)
    # exact host error diffusion when the native lib is present, else ordered
    assert cfg.dither in ("error_diffusion_host", "ordered")
    assert cfg.out_depth == 8


def test_effective_pix_fmt_negotiation():
    info = VideoInfo(pix_fmt="yuv420p", bit_depth=8)
    spec = build_render_spec(
        SRC, OUT, ProcessingParams(video_codec="prores_ks"), LUT, info
    )
    assert spec.pix_fmt is None
    assert effective_output_pix_fmt(spec, info) == "yuv422p10le"


def test_output_fps_ntsc_snap():
    info = VideoInfo(fps=23.976)
    spec = build_render_spec(SRC, OUT, ProcessingParams(), LUT, info)
    assert output_fps(spec, info) == Fraction(24000, 1001)


def test_encoder_settings_carry_tags_and_rates():
    info = VideoInfo(fps=25.0, pix_fmt="yuv420p", bit_depth=8)
    spec = build_render_spec(
        SRC, OUT, ProcessingParams(bitrate="8M", video_codec="mpeg4"), LUT, info
    )
    s = derive_encoder_settings(spec, info, 320, 240)
    assert s.bitrate == "8M" and s.maxrate == "8M" and s.bufsize == "16M"
    assert s.gop == 25
    assert s.color_primaries == "bt709" and s.color_range == "tv"
    assert s.fps == Fraction(25)


# ---- frame scheduler --------------------------------------------------------

def _fake_frames(times):
    for i, t in enumerate(times):
        yield DecodedFrame(
            index=i, pts=int(t * 1000), pts_seconds=t,
            y=np.full((2, 2), i, np.uint8), u=np.zeros((1, 1), np.uint8),
            v=np.zeros((1, 1), np.uint8), pix_fmt="yuv420p", bit_depth=8,
            full_range_hint=False,
        )


def test_scheduler_passthrough():
    frames = list(FrameScheduler("passthrough", Fraction(25)).schedule(
        _fake_frames([0, 0.04, 0.08])
    ))
    assert [f.index for f in frames] == [0, 1, 2]


def test_scheduler_cfr_duplicates_slow_input():
    """10 fps input to 20 fps output: each frame roughly doubled."""
    out = list(FrameScheduler("cfr", Fraction(20)).schedule(
        _fake_frames([0.0, 0.1, 0.2, 0.3])
    ))
    assert len(out) in (6, 7, 8)
    idx = [f.index for f in out]
    assert idx == sorted(idx)
    assert max(idx.count(i) for i in set(idx)) >= 2


def test_scheduler_cfr_drops_fast_input():
    """50 fps input to 25 fps output: about half the frames survive."""
    times = [i / 50 for i in range(20)]
    out = list(FrameScheduler("cfr", Fraction(25)).schedule(_fake_frames(times)))
    assert 9 <= len(out) <= 12
    idx = [f.index for f in out]
    assert idx == sorted(idx) and len(set(idx)) == len(idx)


# ---- end-to-end stage runs (CPU, gather strategy) ---------------------------

@pytest.fixture(scope="module")
def small_clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    return make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=10)


@pytest.fixture(scope="module")
def warm_lut(tmp_path_factory):
    d = tmp_path_factory.mktemp("luts")
    ident = Lut3D.identity(9)
    warm = ident.table.copy()
    warm[..., 0] = np.clip(warm[..., 0] * 1.2, 0, 1)
    return write_cube_file(d / "warm.cube", Lut3D(table=warm, title="warm"))


def test_stage_end_to_end(small_clip, warm_lut, tmp_path):
    info = probe_video(small_clip)
    prep = prepare_lut(parse_cube_file(warm_lut))
    out = tmp_path / "out.mov"
    spec = build_render_spec(
        Path(small_clip), out,
        ProcessingParams(video_codec="prores_ks", profile="3"),
        Path(warm_lut), info,
    )
    progs, logs = [], []
    res = run_stage(spec, info, prep, progress_cb=progs.append,
                    log_cb=logs.append)
    assert res.ok, res.error
    assert progs[-1] == 100
    assert res.stats.frames_out == 10
    oinfo = probe_video(out)
    assert oinfo.codec_name == "prores"
    assert oinfo.nb_frames == 10
    assert oinfo.color_range == "tv"
    # red boost visible in the V plane
    with VideoDecoder(small_clip) as d:
        fin = d.read_frame()
    with VideoDecoder(out) as d:
        fout = d.read_frame()
    assert fout.v.astype(float).mean() / 4 > fin.v.astype(float).mean() + 2


def test_stage_no_lut_passthrough_quality(small_clip, tmp_path):
    info = probe_video(small_clip)
    out = tmp_path / "nolut.mov"
    spec = build_render_spec(
        Path(small_clip), out, ProcessingParams(video_codec="prores_ks"),
        None, info,
    )
    res = run_stage(spec, info, None)
    assert res.ok, res.error
    with VideoDecoder(small_clip) as d:
        fin = d.read_frame()
    with VideoDecoder(out) as d:
        fout = d.read_frame()
    dy = np.abs(fout.y.astype(float) / 4 - fin.y.astype(float))
    assert float(np.median(dy)) <= 1.5


def test_stage_cancel(small_clip, warm_lut, tmp_path):
    info = probe_video(small_clip)
    prep = prepare_lut(parse_cube_file(warm_lut))
    out = tmp_path / "cancel.mov"
    spec = build_render_spec(
        Path(small_clip), out,
        ProcessingParams(video_codec="prores_ks"), Path(warm_lut), info,
    )
    ev = threading.Event()
    ev.set()  # cancel before the first batch
    res = run_stage(spec, info, prep, cancel=ev)
    assert not res.ok and res.canceled


def test_stage_bad_encoder(small_clip, warm_lut, tmp_path):
    info = probe_video(small_clip)
    spec = build_render_spec(
        Path(small_clip), tmp_path / "x.mp4",
        ProcessingParams(video_codec="libx264"), None, info,
    )
    res = run_stage(spec, info, None)
    assert not res.ok
    assert "encoder" in res.error


def test_stage_resize(small_clip, tmp_path):
    info = probe_video(small_clip)
    out = tmp_path / "resized.mov"
    spec = build_render_spec(
        Path(small_clip), out,
        ProcessingParams(video_codec="prores_ks", resolution="32x32"),
        None, info,
    )
    res = run_stage(spec, info, None)
    assert res.ok, res.error
    oinfo = probe_video(out)
    assert (oinfo.width, oinfo.height) == (32, 32)


def test_crf_mapping_rate_model():
    """CRF -> qscale follows x264's rate model: q doubles per +6 CRF,
    anchored at CRF 23 ~ q4, clamped to the MPEG-4 1..31 range."""
    import dataclasses

    from lut_renderer_tpu.engine.config import derive_encoder_settings
    from lut_renderer_tpu.plan.policy import RenderSpec

    def q(crf):
        spec = RenderSpec(source=Path("a.mp4"), output=Path("b.mp4"),
                          video_codec="mpeg4", crf=str(crf))
        return derive_encoder_settings(spec, None, 64, 64).qscale

    assert q(23) == 4
    assert q(29) == 8      # +6 -> double
    assert q(17) == 2      # -6 -> half
    assert q(11) == 1      # clamp low
    assert q(51) == 31     # clamp high
    vals = [q(c) for c in range(10, 52, 3)]
    assert vals == sorted(vals)  # monotonic


def test_crf_native_vp9_mapping():
    """libvpx-vp9 gets the native crf option (0-63, clamped), NOT the
    mpeg4 qscale shim; the policy note names the mechanism used."""
    from lut_renderer_tpu.engine.config import (crf_mechanism,
                                                derive_encoder_settings)
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan.policy import RenderSpec, build_render_spec

    assert crf_mechanism("libvpx-vp9") == "native"
    assert crf_mechanism("mpeg4") == "qscale"

    def settings(crf, codec="libvpx-vp9"):
        spec = RenderSpec(source=Path("a.mp4"), output=Path("b.webm"),
                          video_codec=codec, crf=str(crf))
        return derive_encoder_settings(spec, None, 64, 64)

    s = settings(31)
    assert s.crf == 31 and s.qscale is None
    assert settings(99).crf == 63      # clamp to vp9's quantizer range
    assert settings(-5).crf == 0
    # the qscale shim still applies to codecs without native CRF
    m = settings(23, codec="mpeg4")
    assert m.qscale == 4 and m.crf is None

    # policy note names the mechanism per codec
    notes = []
    p_vp9 = ProcessingParams(video_codec="libvpx-vp9", crf="31")
    build_render_spec(Path("a.mp4"), Path("b.webm"), p_vp9, notes=notes)
    assert any("native crf" in n for n in notes), notes
    notes = []
    p_m4 = ProcessingParams(video_codec="mpeg4", crf="31")
    build_render_spec(Path("a.mp4"), Path("b.mp4"), p_m4, notes=notes)
    assert any("qscale" in n for n in notes), notes


def test_crf_drives_encoded_size_vp9(tmp_path):
    """vp9 analog of the mpeg4 size-ordering test: the native crf option
    must actually drive the bundled libvpx-vp9 encoder (higher CRF ->
    smaller file in b=0 constant-quality mode)."""
    import cv2

    from lut_renderer_tpu.plan.policy import RenderSpec

    clip = tmp_path / "n.mp4"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"),
                         25.0, (96, 64))
    nrng = np.random.default_rng(0)
    for _ in range(6):
        wr.write(nrng.integers(0, 255, (64, 96, 3)).astype(np.uint8))
    wr.release()
    info = probe_video(clip)
    sizes = {}
    for crf in ("10", "55"):
        out = tmp_path / f"crf{crf}.webm"
        spec = RenderSpec(source=clip, output=out, video_codec="libvpx-vp9",
                          crf=crf)
        res = run_stage(spec, info, None)
        assert res.ok, res.error
        sizes[crf] = out.stat().st_size
    assert sizes["10"] > sizes["55"]


def test_crf_drives_encoded_size(tmp_path):
    """Higher CRF -> coarser qscale -> smaller file (end-to-end through the
    real encoder)."""
    import cv2

    from lut_renderer_tpu.plan.policy import RenderSpec

    # noisy content so quality actually costs bits (gradients compress to
    # the container floor at any qscale)
    clip = tmp_path / "n.mp4"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"),
                         25.0, (96, 64))
    nrng = np.random.default_rng(0)
    for _ in range(6):
        wr.write(nrng.integers(0, 255, (64, 96, 3)).astype(np.uint8))
    wr.release()
    info = probe_video(clip)
    sizes = {}
    for crf in ("18", "38"):
        out = tmp_path / f"crf{crf}.mp4"
        spec = RenderSpec(source=clip, output=out, video_codec="mpeg4",
                          crf=crf)
        res = run_stage(spec, info, None)
        assert res.ok, res.error
        sizes[crf] = out.stat().st_size
    assert sizes["18"] > sizes["38"]


def test_run_stage_corrupt_source_fails_cleanly(tmp_path):
    """A non-media file must fail with a decode error, not an exception,
    and must not leave a partial output behind (reference contract: FFmpeg
    exit code -> FAILED with message)."""
    from lut_renderer_tpu.plan.policy import RenderSpec

    bad = tmp_path / "garbage.mp4"
    bad.write_bytes(b"not a movie" * 1024)
    out = tmp_path / "out.mp4"
    spec = RenderSpec(source=bad, output=out, video_codec="mpeg4")
    res = run_stage(spec, None, None)
    assert not res.ok
    assert "decode" in res.error.lower() or "open" in res.error.lower()


def test_run_stage_unwritable_output_fails_cleanly(tmp_path):
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    from lut_renderer_tpu.plan.policy import RenderSpec

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=4)
    info = probe_video(clip)
    spec = RenderSpec(source=clip, output=Path("/nonexistent-dir/x.mp4"),
                      video_codec="mpeg4")
    res = run_stage(spec, info, None)
    assert not res.ok and res.error


def test_run_stage_profiler_trace(tmp_path):
    """--profile writes a jax profiler trace (SURVEY §5.1's tracing story)."""
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 64, fps=25.0, frames=4)
    info = probe_video(clip)
    spec = build_render_spec(Path(clip), tmp_path / "o.mov",
                             ProcessingParams(video_codec="prores_ks"),
                             None, info)
    tdir = tmp_path / "trace"
    res = run_stage(spec, info, None,
                    profile_dir=str(tdir))
    assert res.ok, res.error
    assert any(tdir.rglob("*"))  # trace artifacts written


def test_run_stage_injected_decoder_and_encoder(tmp_path):
    """run_stage takes an already-open frame source and an encoder factory
    (what chip_smoke.py drives without media files): every frame reaches
    the sink, rendered exactly as the jitted step renders it, across a
    partial last batch."""
    from lut_renderer_tpu.ops.render import make_render_fn

    info = VideoInfo(width=64, height=32, fps=25.0, pix_fmt="yuv422p10le",
                     bit_depth=10)
    spec = build_render_spec(SRC, OUT, ProcessingParams(video_codec="prores_ks"),
                             LUT, info)
    prep = prepare_lut(Lut3D.identity(9))
    rng = np.random.default_rng(4)
    y = rng.integers(64, 941, (5, 32, 64)).astype(np.uint16)
    u = rng.integers(64, 961, (5, 32, 32)).astype(np.uint16)
    v = rng.integers(64, 961, (5, 32, 32)).astype(np.uint16)

    class Source:
        width, height = 64, 32
        closed = False

        def __iter__(self):
            for i in range(5):
                yield DecodedFrame(i, None, None, y[i], u[i], v[i],
                                   "yuv422p10le", 10, False)

        def close(self):
            self.closed = True

    opened, frames = [], []

    class Sink:
        def __init__(self, output, settings, **audio):
            opened.append((output, settings.pix_fmt))

        def write(self, *planes):
            frames.append(tuple(np.array(p) for p in planes))

        def close(self):
            pass

    src = Source()
    res = run_stage(spec, info, prep, batch_size=2, use_mesh=False,
                    decoder=src, encoder_factory=Sink)
    assert res.ok, res.error
    assert opened == [(OUT, "yuv422p10le")] and src.closed
    assert len(frames) == 5 and res.stats.batches == 3
    want = make_render_fn(prep, derive_render_config(spec, info))(y, u, v)
    for i, got in enumerate(frames):
        for a, e in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(e)[i])


def test_warmup_programs_cpu():
    """engine.warmup drives the exact executor entry points (make_render_fn
    with the table as an argument) over the production program set; a tiny
    program must run and report ok."""
    from lut_renderer_tpu.engine.warmup import WarmupProgram, warmup_programs

    logs = []
    recs = warmup_programs(
        log=logs.append,
        programs=[
            WarmupProgram("tiny 33", 128, 64, 33),
            WarmupProgram("tiny 65 10-bit 422", 128, 64, 65,
                          in_depth=10, in_subsampling="422"),
        ],
        batch_size=2,
    )
    assert all(r["ok"] for r in recs), recs
    assert [r["label"] for r in recs] == ["tiny 33", "tiny 65 10-bit 422"]
    assert all(r["batch"] == 2 for r in recs)
    assert len(logs) == 2 and all("warmup:" in l for l in logs)


def test_warmup_ladder_covers_geometry_buckets():
    """Drift pin: every serving bucket (engine.geometry.BUCKETS) except
    the documented 8K compile-on-first-use rung must have a warmup
    program at its exact geometry — otherwise pick_bucket routes ad hoc
    jobs onto shapes `serve --warmup` never compiled and a cold compile
    quietly returns."""
    from lut_renderer_tpu.engine.geometry import BUCKETS
    from lut_renderer_tpu.engine.warmup import DEFAULT_PROGRAMS

    warmed = {(p.width, p.height) for p in DEFAULT_PROGRAMS}
    missing = [b for b in BUCKETS if b != (7680, 4320) and b not in warmed]
    assert not missing, f"buckets without warmup programs: {missing}"
    # the ad hoc serving class: 8-bit 4:2:0 at 33^3
    for p in DEFAULT_PROGRAMS:
        if p.label.startswith("bucket ") and "10-bit" not in p.label:
            assert (p.in_depth, p.in_subsampling, p.lut_size) == (8, "420", 33)
