"""Derivation of static pipeline/encoder configs from a RenderSpec + probe.

This is the glue between the pure policy layer (plan.policy — the argv-free
equivalent of the reference's build_command) and the concrete device render op /
host encoder. Everything here is pure and unit-testable.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

from ..models import VideoInfo
from ..models.video_info import infer_bit_depth, parse_fraction
from ..ops.render import RenderConfig
from ..plan.policy import RenderSpec
from ..hostio.encode import EncoderSettings

DEFAULT_MATRIX = "bt709"


def parse_pix_fmt(pix_fmt: Optional[str]) -> Tuple[int, str]:
    """pix_fmt name -> (bit_depth, subsampling '420'/'422'/'444')."""
    if not pix_fmt:
        return 8, "420"
    depth = infer_bit_depth(pix_fmt) or 8
    if "444" in pix_fmt:
        sub = "444"
    elif "422" in pix_fmt:
        sub = "422"
    else:
        sub = "420"
    return depth, sub


def _matrix_from_tags(name: Optional[str]) -> Optional[str]:
    if not name:
        return None
    from ..colorcore.matrices import MATRIX_COEFFS

    n = str(name).lower()
    return n if n in MATRIX_COEFFS else None


def derive_render_config(spec: RenderSpec, info: Optional[VideoInfo]) -> RenderConfig:
    """Map the policy engine's structured filter plan onto the device pipeline.

    Mirrors the semantics the reference encodes as an FFmpeg -vf chain
    (scale range/matrix -> format -> lut3d -> dither -> format,
    src/lut_renderer/ffmpeg.py:195-247,304-310)."""
    in_depth = (info.bit_depth if info and info.bit_depth else 8)
    if in_depth not in (8, 10, 12):
        in_depth = 8
    _, in_sub = parse_pix_fmt(info.pix_fmt if info else None)
    in_full = bool(info.is_full_range) if info else False

    work_full = in_full
    dither = "none"
    for step in spec.filters:
        if step.kind == "range_normalize":
            work_full = step.args.get("out_range") == "pc"
        elif step.kind == "dither":
            dither = str(step.args.get("mode", "ordered"))
            if dither == "error_diffusion":
                try:
                    from ..native_ext import native_available

                    dither = (
                        "error_diffusion_host"
                        if native_available() else "ordered"
                    )
                except Exception:
                    dither = "ordered"

    # Matrix for YUV->RGB before the LUT: the resolved policy matrix, else the
    # source's own colorspace when recognized, else bt709 (FFmpeg's effective
    # default for HD when nothing is forced).
    matrix_in = (
        spec.lut_input_matrix
        or _matrix_from_tags(info.colorspace if info else None)
        or DEFAULT_MATRIX
    )
    # Matrix for RGB->YUV after the LUT: the tagged output colorspace if the
    # policy writes tags, else same as input.
    matrix_out = _matrix_from_tags(spec.color_tags.colorspace) or matrix_in
    out_full = (spec.color_tags.range or ("pc" if work_full else "tv")) == "pc"

    out_depth, out_sub = parse_pix_fmt(spec.pix_fmt or (info.pix_fmt if info else None))
    if not spec.pix_fmt and info and info.bit_depth:
        out_depth = in_depth
    resize = parse_resolution(spec.resolution)
    return RenderConfig(
        in_depth=in_depth,
        out_depth=out_depth,
        in_subsampling=in_sub,
        out_subsampling=out_sub,
        in_full_range=in_full,
        work_full_range=work_full,
        out_full_range=out_full,
        matrix_in=matrix_in,
        matrix_out=matrix_out,
        interp=spec.lut_interp,
        dither=dither,
        apply_lut=spec.lut_path is not None,
        resize=resize,
    )


def parse_resolution(text: Optional[str]) -> Optional[Tuple[int, int]]:
    """'1920x1080' -> (1920, 1080); tolerant of junk (None)."""
    if not text:
        return None
    t = str(text).lower().replace("*", "x")
    if "x" not in t:
        return None
    try:
        w, h = t.split("x", 1)
        w, h = int(w), int(h)
    except ValueError:
        return None
    if w <= 0 or h <= 0:
        return None
    return w, h


def _fps_fraction(text: Optional[str], fallback: Optional[float]) -> Fraction:
    val = parse_fraction(text) if text else None
    if val is None:
        val = fallback
    if not val or val <= 0:
        val = 25.0
    # snap common NTSC rates to their exact fractions
    for num, den in ((24000, 1001), (30000, 1001), (60000, 1001)):
        if abs(val - num / den) < 0.005:
            return Fraction(num, den)
    return Fraction(val).limit_denominator(10000)


def effective_output_pix_fmt(spec: RenderSpec, info: Optional[VideoInfo]) -> str:
    """The pixel format the stage will actually produce.

    When the policy leaves pix_fmt unset, negotiate with the encoder's
    supported formats (FFmpeg's CLI does this implicitly when no -pix_fmt is
    passed; prores_ks would otherwise reject yuv420p)."""
    if spec.pix_fmt:
        return spec.pix_fmt
    in_depth = info.bit_depth if info and info.bit_depth else 8
    _, in_sub = parse_pix_fmt(info.pix_fmt if info else None)
    try:
        from ..hostio.encode import pick_encoder_pix_fmt

        picked = pick_encoder_pix_fmt(spec.video_codec, in_depth, in_sub)
    except Exception:
        picked = None
    return picked or "yuv420p"


def output_fps(spec: RenderSpec, info: Optional[VideoInfo]) -> Fraction:
    """Output frame rate under the policy's time-structure rules
    (cfr with explicit/source rate, else source rate passthrough)."""
    if spec.fps_mode == "cfr" and spec.output_fps:
        return _fps_fraction(spec.output_fps, info.fps if info else None)
    return _fps_fraction(None, info.fps if info else None)


# Bundled encoders that implement CRF rate control natively (AVOption
# `crf`). libvpx-vp9's quantizer range is 0-63; constant-quality mode needs
# b=0 (reference passthrough: /root/reference/src/lut_renderer/ffmpeg.py:
# 323-325 trusts the encoder to honor -crf).
NATIVE_CRF_CODECS = frozenset({"libvpx-vp9", "libvpx", "vp9"})


def crf_mechanism(codec: str) -> str:
    """How a CRF request is realized for `codec`: "native" (the encoder's
    own crf option) or "qscale" (the mpeg4/mjpeg 1-31 quantizer shim)."""
    return "native" if codec in NATIVE_CRF_CODECS else "qscale"


def derive_encoder_settings(
    spec: RenderSpec,
    info: Optional[VideoInfo],
    width: int,
    height: int,
) -> EncoderSettings:
    fps = output_fps(spec, info)
    out_depth, out_sub = parse_pix_fmt(spec.pix_fmt)
    pix_fmt = spec.pix_fmt or "yuv420p"
    tags = spec.color_tags
    qscale = None
    crf = None
    if spec.crf:
        mech = crf_mechanism(spec.video_codec)
        try:
            crf_val = float(spec.crf)
        except ValueError:
            crf_val = None
        if crf_val is not None and mech == "native":
            # libvpx-vp9 implements CRF natively (`crf` AVOption, quantizer
            # range 0-63) — pass it through like the reference does for
            # CRF-capable encoders (ffmpeg.py:323-325). The encoder layer
            # adds b=0 for constant-quality mode when no bitrate is set
            # (with a bitrate it is libvpx constrained quality, matching
            # the ffmpeg CLI's own -crf/-b:v interaction).
            crf = max(0, min(63, round(crf_val)))
        elif crf_val is not None:
            # No native-CRF mechanism for this codec in the bundled libs
            # (no libx264/x265); map CRF onto MPEG-4/MJPEG qscale on x264's
            # own rate model: bitrate halves per +6 CRF, and qscale is
            # ~inverse-proportional to bitrate, so
            #     qscale = q0 * 2^((crf - 23) / 6),  anchored at CRF 23 ~ q4
            # ("default quality" on both scales). Monotonic, matches the
            # rate DOUBLING behavior users expect from the CRF knob
            # (calibrated by tests/test_engine.py::test_crf_mapping_rate_
            # model); the policy layer notes the substitution.
            qscale = max(1, min(31, round(4.0 * 2.0 **
                                          ((crf_val - 23.0) / 6.0))))
    gop = spec.gop
    return EncoderSettings(
        codec=spec.video_codec,
        width=width,
        height=height,
        pix_fmt=pix_fmt,
        fps=fps,
        bitrate=spec.bitrate,
        maxrate=spec.maxrate,
        bufsize=spec.bufsize,
        gop=gop,
        profile=spec.profile,
        level=spec.level,
        threads=spec.threads,
        qscale=qscale,
        crf=crf,
        color_primaries=tags.primaries,
        color_trc=tags.trc,
        colorspace=tags.colorspace,
        color_range=tags.range,
        faststart=spec.faststart,
    )
