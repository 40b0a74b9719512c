"""Policy engine: ProcessingParams + probe info -> a structured RenderSpec.

This is the semantic equivalent of the reference's `build_command`
(src/lut_renderer/ffmpeg.py:179-414), which compiles user params + probe data
into an FFmpeg argv. Here the output is a *structured plan* consumed by the
device engine instead of an argv string, but every policy decision is carried
over one-to-one:

  * streamcopy + filters is a hard error            (ffmpeg.py:255-256)
  * LUT input matrix auto/bt709/none + whitelist    (ffmpeg.py:199-240, 113-126)
  * full-range (yuvj*/pc) normalization + chroma-
    preserving intermediate format                  (ffmpeg.py:129-143, 212-233)
  * interp validation with tetrahedral fallback     (ffmpeg.py:242-247)
  * time structure: explicit fps -> CFR; VFR+force_cfr -> CFR at source rate;
    unknown source+force_cfr -> conservative CFR; else passthrough
                                                    (ffmpeg.py:258-285)
  * bit-depth policy incl. the 10-bit-capable codec set and prores 422p10le
    vs generic 420p10le choice                      (ffmpeg.py:287-302, 109-110)
  * dither request before format conversion         (ffmpeg.py:304-310)
  * bitrate stabilization maxrate=b, bufsize=2b     (ffmpeg.py:315-321)
  * auto GOP = round(fps) when unset                (ffmpeg.py:332-337)
  * LUT output tags bt709/inherit/none w/ fallback  (ffmpeg.py:348-386)
  * videotoolbox high-bitrate caution note          (ffmpeg.py:388-395)

Each decision also appends a human-readable English `note`, preserving the
reference's self-explaining-plan mechanism (SURVEY.md §5.5).

Everything here is pure: no I/O, no device code — unit-testable without media,
exactly like the reference's smoke-test seam (src/lut_renderer/smoke.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..models import ProcessingParams, VideoInfo

_BITRATE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)([kKmMgG]?)\s*$")

VALID_INTERP = {"nearest", "trilinear", "tetrahedral", "pyramid", "prism", "cubic"}
# Interp modes natively implemented by the device LUT core (all of FFmpeg lut3d's
# working set). "cubic" is an accepted NAME upstream that FFmpeg's own lut3d
# rejects at runtime; here it degrades to tetrahedral with a note.
KERNEL_INTERP = {"nearest", "trilinear", "tetrahedral", "pyramid", "prism"}

TEN_BIT_CODECS = {
    "prores_ks", "libx265", "hevc_videotoolbox",
    # bundled pro-mastering codecs beyond the reference's menu (verified
    # end-to-end in tests/test_encoders_ext): CineForm, 10-bit uncompressed,
    # DNxHR (HQX profile)
    "cfhd", "v210", "dnxhd",
}

# Preferred 10-bit output format per codec under bit_depth_policy=preserve.
# prores 422p10le vs generic 420p10le mirrors the reference
# (ffmpeg.py:287-302); cfhd/v210/dnxhd are 4:2:2-native encoders.
_TEN_BIT_FMT = {
    "prores_ks": "yuv422p10le",
    "cfhd": "yuv422p10le",
    "v210": "yuv422p10le",
    "dnxhd": "yuv422p10le",
}

_MATRIX_WHITELIST = {"bt709", "smpte170m", "bt470bg", "bt2020nc", "bt2020c"}


class StreamcopyFilterError(ValueError):
    """LUT/filters cannot be combined with video streamcopy."""


def supports_10bit(codec: str) -> bool:
    return codec in TEN_BIT_CODECS


def normalize_matrix_name(value: Optional[str]) -> Optional[str]:
    if not value:
        return None
    text = str(value).strip().lower()
    return text if text in _MATRIX_WHITELIST else None


def parse_bitrate(value: str) -> Optional[Tuple[float, str]]:
    if not value:
        return None
    m = _BITRATE_RE.match(value)
    if not m:
        return None
    number = float(m.group(1))
    if number <= 0:
        return None
    return number, m.group(2) or ""


def scale_bitrate(value: str, factor: float) -> Optional[str]:
    parsed = parse_bitrate(value)
    if not parsed:
        return None
    number, unit = parsed
    number *= factor
    if abs(number - round(number)) < 1e-6:
        return f"{int(round(number))}{unit}"
    return f"{number:g}{unit}"


def bitrate_to_kbps(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    parsed = parse_bitrate(value)
    if not parsed:
        return None
    number, unit = parsed
    unit = unit.lower()
    if unit == "k":
        return number
    if unit == "m":
        return number * 1e3
    if unit == "g":
        return number * 1e6
    return None  # unitless bits/s is not interpreted (reference behavior)


def format_fps(value: float) -> str:
    text = f"{value:.3f}"
    return text.rstrip("0").rstrip(".")


@dataclass
class FilterStep:
    """One step of the pixel pipeline the engine will fuse into the kernel."""

    kind: str  # "range_normalize" | "to_rgb" | "lut3d" | "dither" | "format"
    args: Dict[str, object] = field(default_factory=dict)

    def __repr__(self) -> str:  # compact, stable for tests/logs
        inner = ":".join(f"{k}={v}" for k, v in sorted(self.args.items()))
        return f"{self.kind}({inner})"


@dataclass
class ColorTags:
    primaries: Optional[str] = None
    trc: Optional[str] = None
    colorspace: Optional[str] = None
    range: Optional[str] = None

    def any(self) -> bool:
        return any([self.primaries, self.trc, self.colorspace, self.range])


@dataclass
class RenderSpec:
    """The full structured plan for one render stage."""

    source: Path
    output: Path
    overwrite: bool = True
    # pixel pipeline
    filters: List[FilterStep] = field(default_factory=list)
    lut_path: Optional[Path] = None
    lut_interp: str = "tetrahedral"
    lut_input_matrix: Optional[str] = None  # resolved matrix or None (engine default)
    # time structure
    fps_mode: str = "passthrough"  # "cfr" | "passthrough"
    output_fps: Optional[str] = None
    # encoder
    video_codec: str = ""
    audio_codec: str = ""
    pix_fmt: Optional[str] = None
    resolution: Optional[str] = None
    bitrate: Optional[str] = None
    maxrate: Optional[str] = None
    bufsize: Optional[str] = None
    crf: Optional[str] = None
    preset: Optional[str] = None
    tune: Optional[str] = None
    gop: Optional[int] = None
    profile: Optional[str] = None
    level: Optional[str] = None
    threads: Optional[str] = None
    audio_bitrate: Optional[str] = None
    sample_rate: Optional[str] = None
    channels: Optional[str] = None
    faststart: bool = False
    color_tags: ColorTags = field(default_factory=ColorTags)
    notes: List[str] = field(default_factory=list)

    @property
    def is_streamcopy(self) -> bool:
        return self.video_codec == "copy"

    def filter_kinds(self) -> List[str]:
        return [f.kind for f in self.filters]


def _resolve_fps(params: ProcessingParams, info: Optional[VideoInfo]):
    from ..models.video_info import parse_fraction

    if params.fps:
        return parse_fraction(params.fps), params.fps
    if info and info.fps:
        return info.fps, format_fps(info.fps)
    return None, None


def _full_range_intermediate_pix_fmt(info: Optional[VideoInfo]) -> str:
    pix_fmt = str(info.pix_fmt) if info and info.pix_fmt else ""
    if "444" in pix_fmt:
        return "yuv444p"
    if "422" in pix_fmt:
        return "yuv422p"
    return "yuv420p"


def _inherit_tags(info: Optional[VideoInfo], tags: ColorTags, notes: List[str]) -> None:
    if not info:
        return
    items = []
    if info.color_primaries:
        tags.primaries = info.color_primaries
        items.append(f"primaries={info.color_primaries}")
    if info.color_trc:
        tags.trc = info.color_trc
        items.append(f"trc={info.color_trc}")
    if info.colorspace:
        tags.colorspace = info.colorspace
        items.append(f"colorspace={info.colorspace}")
    if info.color_range:
        tags.range = info.color_range
        items.append(f"range={info.color_range}")
    if items:
        notes.append(f"Inherited color metadata: {', '.join(items)}")


def build_render_spec(
    source: Path,
    output: Path,
    params: ProcessingParams,
    lut_path: Optional[Path] = None,
    source_info: Optional[VideoInfo] = None,
    notes: Optional[List[str]] = None,
) -> RenderSpec:
    notes = notes if notes is not None else []
    spec = RenderSpec(
        source=Path(source),
        output=Path(output),
        overwrite=params.overwrite,
        video_codec=params.video_codec,
        audio_codec=params.audio_codec,
        notes=notes,
    )

    # ---- pixel filter chain (only when a LUT is in play) -------------------
    if lut_path:
        tag_policy = (params.lut_output_tags or "bt709").strip().lower()
        matrix_policy = (params.lut_input_matrix or "auto").strip().lower()
        if matrix_policy == "bt709":
            matrix = "bt709"
        elif matrix_policy == "auto":
            matrix = normalize_matrix_name(source_info.colorspace if source_info else None)
        elif matrix_policy == "none":
            matrix = None
        else:
            matrix = normalize_matrix_name(matrix_policy)
        spec.lut_input_matrix = matrix

        if source_info is not None and source_info.is_full_range:
            out_range = "pc"
            if tag_policy == "bt709":
                out_range = "tv"
            elif tag_policy == "inherit":
                out_range = (
                    str(source_info.color_range).lower().strip()
                    if source_info.color_range
                    else "pc"
                )
            elif tag_policy == "none":
                out_range = "pc"
            intermediate = _full_range_intermediate_pix_fmt(source_info)
            spec.filters.append(
                FilterStep(
                    "range_normalize",
                    {"in_range": "pc", "out_range": out_range, "format": intermediate},
                )
            )
            notes.append(
                f"Range: full-range (pc) source detected; normalized to "
                f"out_range={out_range}, avoiding legacy yuvj* formats "
                f"(format={intermediate})"
            )
            if matrix:
                notes.append(f"LUT input matrix: {matrix} ({matrix_policy})")
        elif matrix:
            notes.append(f"LUT input matrix: {matrix} ({matrix_policy})")
        else:
            notes.append(
                "LUT input matrix: not forced (auto/none or unrecognized source colorspace)"
            )

        interp = params.lut_interp or "tetrahedral"
        if interp not in VALID_INTERP:
            interp = "tetrahedral"
        if interp not in KERNEL_INTERP:
            notes.append(
                f"LUT interp: {interp} not implemented natively; using tetrahedral"
            )
            interp = "tetrahedral"
        spec.lut_interp = interp
        spec.lut_path = Path(lut_path)
        spec.filters.append(FilterStep("lut3d", {"file": str(lut_path), "interp": interp}))
        notes.append(f"LUT: lut3d kernel (interp={interp})")

    if spec.filters and params.video_codec == "copy":
        raise StreamcopyFilterError(
            "LUT/filters cannot be combined with video streamcopy "
            "(codec 'copy' bypasses the pixel pipeline)."
        )

    # ---- encode-side policy (skipped entirely for streamcopy) --------------
    if params.video_codec and params.video_codec != "copy":
        fps_value, source_fps_text = _resolve_fps(params, source_info)

        if params.fps:
            spec.fps_mode = "cfr"
            spec.output_fps = params.fps
            notes.append(f"Time structure: fps_mode=cfr, output fps={params.fps}")
        else:
            source_is_vfr = bool(source_info and source_info.is_vfr)
            if source_is_vfr and params.force_cfr:
                spec.fps_mode = "cfr"
                if source_fps_text:
                    spec.output_fps = source_fps_text
                    notes.append(
                        f"Time structure: VFR source, forcing CFR at {source_fps_text} fps"
                    )
                else:
                    notes.append("Time structure: VFR source, forcing CFR (rate unknown)")
            elif params.force_cfr and source_info is None:
                spec.fps_mode = "cfr"
                notes.append("Time structure: fps_mode=cfr (source not probed)")
            else:
                spec.fps_mode = "passthrough"
                if source_is_vfr:
                    notes.append(
                        "Time structure: VFR source, fps_mode=passthrough (no timestamp rewrite)"
                    )
                else:
                    notes.append(
                        "Time structure: CFR/unknown source, fps_mode=passthrough "
                        "(avoiding timestamp rewrite)"
                    )

        profile = params.profile or None
        if (
            params.video_codec == "dnxhd"
            and source_info
            and source_info.width
            and source_info.height
            and not params.resolution
            and (source_info.width < 256 or source_info.height < 120)
        ):
            notes.append(
                f"Warning: DNxHD/DNxHR requires at least 256x120 input; "
                f"source is {source_info.width}x{source_info.height} — the "
                f"encode stage will fail unless --resolution upscales it"
            )
        if params.video_codec == "dnxhd" and not profile:
            # Classic DNxHD profiles demand exact resolution/rate/bitrate
            # tables (the ffmpeg CLI errors on a mismatch); DNxHR is
            # resolution-independent. Default to DNxHR HQ.
            profile = "dnxhr_hq"
            notes.append(
                "DNxHD without a profile: defaulting to dnxhr_hq "
                "(resolution-independent; classic DNxHD needs exact "
                "resolution/bitrate pairs)"
            )

        pix_fmt = params.pix_fmt
        if params.bit_depth_policy == "force_8bit":
            if pix_fmt != "yuv420p":
                notes.append("Bit-depth policy=force 8-bit: pix_fmt=yuv420p")
            pix_fmt = "yuv420p"
        elif params.bit_depth_policy in {"preserve", "auto"} and not pix_fmt:
            if source_info and source_info.bit_depth and source_info.bit_depth >= 10:
                if supports_10bit(params.video_codec):
                    pix_fmt = _TEN_BIT_FMT.get(params.video_codec, "yuv420p10le")
                    notes.append(f"Bit-depth policy=preserve 10-bit: pix_fmt={pix_fmt}")
                    if params.video_codec == "dnxhd" and profile not in (
                        "dnxhr_hqx", "dnxhr_444"
                    ):
                        # DNxHR 10-bit lives in the HQX/444 profiles only
                        profile = "dnxhr_hqx"
                        notes.append(
                            "DNxHR 10-bit requires the HQX profile: "
                            "profile=dnxhr_hqx"
                        )
                else:
                    pix_fmt = "yuv420p"
                    notes.append(
                        "Bit-depth policy=preserve 10-bit: encoder lacks 10-bit, "
                        "falling back to yuv420p"
                    )
        if params.video_codec == "dnxhd" and not pix_fmt:
            # profile drives the bit depth here; negotiation by encoder
            # format list alone cannot see the profile
            pix_fmt = {
                "dnxhr_hqx": "yuv422p10le", "dnxhr_444": "yuv444p10le",
            }.get(profile or "", "yuv422p")
            notes.append(f"DNxHR profile {profile}: pix_fmt={pix_fmt}")

        if pix_fmt:
            requested_dither = params.zscale_dither or "none"
            if requested_dither == "error_diffusion":
                # Execution picks exact host error diffusion (native C++)
                # when available, else the device's spatially-stationary ordered
                # dither (see colorcore.dither for rationale).
                spec.filters.append(
                    FilterStep("dither", {"mode": "error_diffusion"})
                )
                notes.append(
                    "Dither: error_diffusion (exact host pass when the native "
                    "library is present, device ordered dither otherwise)"
                )
            elif requested_dither in ("ordered", "random"):
                # Device dithers beyond the reference's zscale set:
                # ordered (Bayer) and random (position-hash stochastic
                # rounding), both zero-mean and in-pipeline.
                spec.filters.append(
                    FilterStep("dither", {"mode": requested_dither})
                )
                notes.append(f"Dither: {requested_dither} (device in-pipeline)")
            if lut_path:
                spec.filters.append(FilterStep("format", {"pix_fmt": pix_fmt}))
            spec.pix_fmt = pix_fmt

        if params.resolution:
            spec.resolution = params.resolution

        if params.bitrate:
            spec.bitrate = params.bitrate
            bufsize = scale_bitrate(params.bitrate, 2)
            if bufsize:
                spec.maxrate = params.bitrate
                spec.bufsize = bufsize
                notes.append(
                    f"Bitrate stabilization: maxrate={params.bitrate}, bufsize={bufsize}"
                )

        spec.crf = params.crf or None
        if spec.crf:
            # Per-codec CRF mechanism (engine.config.crf_mechanism):
            # libvpx-vp9 honors its own crf option (0-63) like the
            # reference's passthrough (ffmpeg.py:323-325); codecs without
            # native CRF get the qscale substitution — noted honestly.
            from ..engine.config import crf_mechanism

            if crf_mechanism(params.video_codec) == "native":
                notes.append(
                    f"CRF {spec.crf}: native crf rate control "
                    f"({params.video_codec}, quantizer scale 0-63"
                    + ("" if params.bitrate else "; b=0 constant quality")
                    + ")"
                )
            else:
                notes.append(
                    f"CRF {spec.crf}: no native-CRF encoder for "
                    f"'{params.video_codec or 'default codec'}'; mapped to "
                    f"qscale ~4*2^((crf-23)/6) (rate-doubling per +6, "
                    f"anchored CRF 23)"
                )
        spec.preset = params.preset or None
        spec.tune = params.tune or None

        if params.gop:
            try:
                spec.gop = int(float(params.gop))
            except ValueError:
                spec.gop = None
        elif fps_value:
            spec.gop = max(1, round(fps_value))
            notes.append(f"Auto GOP={spec.gop} (fps={format_fps(fps_value)})")

        spec.profile = profile
        spec.level = params.level or None
        spec.threads = params.threads or None

        if lut_path:
            policy = (params.lut_output_tags or "bt709").strip().lower()
            if policy == "bt709":
                spec.color_tags = ColorTags("bt709", "bt709", "bt709", "tv")
                notes.append("LUT output tags: bt709/bt709/bt709, range=tv")
            elif policy == "inherit":
                if params.inherit_color_metadata:
                    _inherit_tags(source_info, spec.color_tags, notes)
            elif policy == "none":
                notes.append("LUT output tags: none (no color metadata written)")
            else:
                spec.color_tags = ColorTags("bt709", "bt709", "bt709", "tv")
                notes.append("LUT output tags: bt709/bt709/bt709, range=tv (fallback)")
        else:
            if params.inherit_color_metadata:
                _inherit_tags(source_info, spec.color_tags, notes)

        if params.video_codec and "videotoolbox" in params.video_codec:
            candidate = params.bitrate or (source_info.bitrate if source_info else "")
            kbps = bitrate_to_kbps(candidate)
            if kbps and kbps >= 50_000:
                notes.append(
                    "Note: hardware H.264 encoders can exhibit PTS-rebuild/frame-"
                    "reorder cadence artifacts at very high bitrates; prefer libx264 "
                    "or the pro mastering mode for stability."
                )

    audio_forced_copy = False
    if params.audio_codec and params.audio_codec != "copy":
        spec.audio_bitrate = params.audio_bitrate or None
        spec.sample_rate = params.sample_rate or None
        spec.channels = params.channels or None
        if spec.channels:
            try:
                nch = int(spec.channels)
            except ValueError:
                nch = None
            from ..hostio.audio import _CHANNEL_LAYOUTS

            if nch is None or nch not in _CHANNEL_LAYOUTS:
                notes.append(
                    f"Audio channels: requested count '{spec.channels}' has "
                    f"no named layout in the bundled libraries "
                    f"(supported: {sorted(_CHANNEL_LAYOUTS)}); the source "
                    f"channel layout will be KEPT"
                )
        # The reference offers aac/mp3/copy (main_window.py:763) with no
        # availability preflight; the bundled libs ship aac/flac/alac/ac3/
        # eac3/mp2/opus/vorbis/pcm but not mp3. Degradation-notes honesty:
        # name the copy fallback up front instead of failing silently at
        # encode time.
        try:
            from ..hostio.encode import (
                audio_reencode_available,
                encoder_available,
            )

            if not encoder_available(params.audio_codec):
                notes.append(
                    f"Audio codec '{params.audio_codec}' is not in the "
                    f"bundled libraries; the audio stream will be COPIED "
                    f"instead (bundled audio encoders: aac, flac, alac, "
                    f"ac3, eac3, mp2, opus, vorbis, pcm)"
                )
            elif not audio_reencode_available():
                audio_forced_copy = True
                notes.append(
                    f"Audio re-encode to '{params.audio_codec}' needs "
                    f"libavfilter, which the loaded FFmpeg libraries lack; "
                    f"the audio stream will be COPIED instead (codec, "
                    f"bitrate, sample rate and channels are not applied)"
                )
        except Exception:
            pass

    # Container/codec compatibility preflight (empirical matrix from the
    # bundled muxers, tests/test_encoders_ext.py): name the failure before
    # the encode stage hits write_header.
    ext = Path(spec.output).suffix.lower() if spec.output else ""
    # Resolve the codecs that will ACTUALLY hit the muxer: a blank video
    # codec falls to the mode template's default at dispatch time, and
    # audio 'copy' carries the SOURCE stream's codec (a default-resolved
    # non-VP9 video or a copied AAC track fails at write_header just as
    # surely as an explicit one).
    eff_video = params.video_codec
    if not eff_video:
        try:
            from ..app.defaults import mode_template

            eff_video = mode_template(params.processing_mode).video_codec
        except Exception:
            eff_video = ""
    eff_audio = params.audio_codec or ""
    audio_copied = eff_audio in ("", "copy") or audio_forced_copy
    if audio_copied and source_info is not None and source_info.audio_codec:
        eff_audio = str(source_info.audio_codec)
    blocked_audio = {
        ".mov": {"flac", "opus"},  # mov muxer: "only supported in MP4"
        ".webm": {"aac", "flac", "alac", "ac3", "eac3", "mp2", "mp3",
                  "pcm_s16le"},   # webm allows only Opus/Vorbis audio
    }.get(ext, set())
    if eff_audio in blocked_audio:
        via = " (copied from the source)" if audio_copied else ""
        notes.append(
            f"Warning: the {ext} container cannot carry {eff_audio} "
            f"audio{via} — the mux will fail; use "
            + (".mp4/.mkv" if ext == ".mov" else "opus or vorbis")
        )
    if ext == ".webm" and eff_video not in (
        "", "copy", "libvpx", "libvpx-vp9", "vp8", "vp9", "av1", "libaom-av1"
    ):
        via = "" if eff_video == params.video_codec else " (mode default)"
        notes.append(
            f"Warning: WebM only carries VP8/VP9/AV1 video — "
            f"{eff_video}{via} will fail at mux time; use libvpx or "
            f"libvpx-vp9, or a .mkv/.mp4 output"
        )

    spec.faststart = bool(params.faststart)
    return spec
