"""Audio path tests: A/V fixtures, stream copy, AAC transcode."""

from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.hostio import (
    EncoderSettings,
    VideoDecoder,
    VideoEncoder,
    probe_video,
)
from lut_renderer_tpu.hostio.audio import free_audio_ctx, transcode_audio_packets
from lut_renderer_tpu.utils.fixtures import make_av_clip, make_sine_wav


@pytest.fixture(scope="module")
def av_clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("av")
    return make_av_clip(d / "av.mov", frames=25, audio_seconds=1.0)


def test_av_fixture_probe(av_clip):
    info = probe_video(av_clip)
    assert info.codec_name == "mpeg4"
    assert info.audio_codec == "pcm_s16le"
    assert info.audio_sample_rate == 48000


def test_wav_fixture(tmp_path):
    wav = make_sine_wav(tmp_path / "t.wav", seconds=0.5)
    info = probe_video(wav)
    assert info.audio_codec == "pcm_s16le"
    assert info.width is None


def test_transcode_to_aac(av_clip):
    res = transcode_audio_packets(av_clip, "aac", 128000)
    assert res is not None
    ctx, pkts, tb = res
    free_audio_ctx(ctx)
    assert tb == (1, 48000)
    assert len(pkts) >= 40  # ~1s at 1024 samples/frame
    # monotonically increasing pts
    pts = [p[1] for p in pkts]
    assert pts == sorted(pts)


def test_transcode_missing_audio(tmp_path):
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    clip = make_gradient_clip(tmp_path / "noaudio.mp4", 64, 64, frames=5)
    assert transcode_audio_packets(clip, "aac") is None


def test_encoder_audio_copy_preserves_pcm(av_clip, tmp_path):
    out = tmp_path / "copy.mov"
    st = EncoderSettings(codec="mpeg4", width=128, height=96,
                         pix_fmt="yuv420p", fps=Fraction(25))
    with VideoDecoder(av_clip) as dec, VideoEncoder(
        out, st, audio_from=Path(av_clip), audio_mode="copy"
    ) as enc:
        for fr in dec:
            enc.write(fr.y, fr.u, fr.v)
    info = probe_video(out)
    assert info.audio_codec == "pcm_s16le"


def test_encoder_audio_transcode_aac(av_clip, tmp_path):
    out = tmp_path / "aac.mp4"
    st = EncoderSettings(codec="mpeg4", width=128, height=96,
                         pix_fmt="yuv420p", fps=Fraction(25))
    with VideoDecoder(av_clip) as dec, VideoEncoder(
        out, st, audio_from=Path(av_clip), audio_mode="aac",
        audio_bitrate="96k",
    ) as enc:
        for fr in dec:
            enc.write(fr.y, fr.u, fr.v)
    info = probe_video(out)
    assert info.audio_codec == "aac"
    assert info.audio_sample_rate == 48000
    assert abs(info.duration - 1.0) < 0.2


def test_engine_stage_with_audio(av_clip, tmp_path):
    """Policy audio_codec=aac flows through the engine to a transcoded track
    (reference default `-c:a aac`, models.py:22)."""
    from lut_renderer_tpu.engine import run_stage
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan import build_render_spec

    info = probe_video(av_clip)
    out = tmp_path / "withaudio.mp4"
    spec = build_render_spec(
        Path(av_clip), out,
        ProcessingParams(video_codec="mpeg4", audio_codec="aac",
                         audio_bitrate="96k"),
        None, info,
    )
    res = run_stage(spec, info, None)
    assert res.ok, res.error
    oinfo = probe_video(out)
    assert oinfo.audio_codec == "aac"


@pytest.fixture()
def no_avfilter(monkeypatch):
    """The loaded FFmpeg libraries as the headless opencv wheel ships them:
    everything but libavfilter."""
    from lut_renderer_tpu.hostio.ffi import FFIUnavailable, get_ffi

    ffi = get_ffi()
    monkeypatch.setattr(ffi, "_avfilter", None)
    monkeypatch.setattr(ffi, "_avfilter_error",
                        FFIUnavailable("missing libavfilter-*.so*"))


@pytest.mark.parametrize("ext,copied_warning", [(".mov", False),
                                                (".webm", True)])
def test_policy_notes_audio_copy_without_avfilter(av_clip, tmp_path,
                                                  no_avfilter, ext,
                                                  copied_warning):
    """No libavfilter: the preflight names the copy that replaces the
    requested re-encode, and the container check sees the copied codec."""
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan import build_render_spec

    info = probe_video(av_clip)
    spec = build_render_spec(
        Path(av_clip), tmp_path / f"out{ext}",
        ProcessingParams(video_codec="mpeg4", audio_codec="aac"), None, info)
    assert any("needs libavfilter" in n and "COPIED" in n
               for n in spec.notes), spec.notes
    assert any("pcm_s16le audio (copied from the source)" in n
               for n in spec.notes) == copied_warning


def test_engine_stage_without_avfilter_copies_audio(av_clip, tmp_path,
                                                    no_avfilter):
    """No libavfilter: the stage still completes, with the source's audio
    stream copied as the preflight note says."""
    from lut_renderer_tpu.engine import run_stage
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan import build_render_spec

    info = probe_video(av_clip)
    out = tmp_path / "copied.mov"
    spec = build_render_spec(
        Path(av_clip), out,
        ProcessingParams(video_codec="mpeg4", audio_codec="aac",
                         audio_bitrate="96k"),
        None, info,
    )
    res = run_stage(spec, info, None)
    assert res.ok, res.error
    assert probe_video(out).audio_codec == "pcm_s16le"
