"""Media probing via libavformat — the rebuild's ffprobe replacement.

Produces the same VideoInfo contract as the reference's ffprobe-JSON parser
(src/lut_renderer/media_info.py:113-226): field names, bitrate "<n>k"
normalization, VFR detection (|avg-r| > 0.1), color tag normalization
dropping unknown/unspecified, bit-depth inference, and the yuvj* -> pc
color-range imputation — but in-process over the bundled libs, with a cv2
fallback when the FFI layer is unavailable.
"""

from __future__ import annotations

from ctypes import byref, c_void_p
from pathlib import Path
from typing import Optional

from ..models import VideoInfo
from ..models.video_info import (
    detect_vfr,
    infer_bit_depth,
    kbps_string,
    normalize_color,
)
from . import ffi as ffimod
from .ffi import (
    AV_NOPTS_VALUE,
    AV_TIME_BASE,
    AVMEDIA_TYPE_AUDIO,
    AVMEDIA_TYPE_VIDEO,
    FFIUnavailable,
    OFF,
    _r_i32,
    _r_i64,
    _r_ptr,
    _r_rational,
    get_ffi,
)

# Public libavutil enum name maps (pixfmt.h / AVColor* — append-only enums).
_COLOR_RANGE = {1: "tv", 2: "pc"}
_COLOR_SPACE = {
    0: "gbr", 1: "bt709", 4: "fcc", 5: "bt470bg", 6: "smpte170m",
    7: "smpte240m", 8: "ycgco", 9: "bt2020nc", 10: "bt2020c",
    11: "smpte2085", 12: "chroma-derived-nc", 13: "chroma-derived-c",
    14: "ictcp",
}
_COLOR_PRIMARIES = {
    1: "bt709", 4: "bt470m", 5: "bt470bg", 6: "smpte170m", 7: "smpte240m",
    8: "film", 9: "bt2020", 10: "smpte428", 11: "smpte431", 12: "smpte432",
    22: "jedec-p22",
}
_COLOR_TRC = {
    1: "bt709", 4: "gamma22", 5: "gamma28", 6: "smpte170m", 7: "smpte240m",
    8: "linear", 9: "log100", 10: "log316", 11: "iec61966-2-4",
    12: "bt1361e", 13: "iec61966-2-1", 14: "bt2020-10", 15: "bt2020-12",
    16: "smpte2084", 17: "smpte428", 18: "arib-std-b67",
}


def _rational_str(r) -> Optional[str]:
    if r.num and r.den:
        return f"{r.num}:{r.den}"
    return None


def _ctx_color_props(ffi, par: int, codec: int):
    """Open a decoder context just to read color props through AVOptions
    (AVCodecParameters color-field offsets are version-sensitive; the
    options table is authoritative)."""
    cctx = ffi.avcodec.avcodec_alloc_context3(c_void_p(codec))
    try:
        if ffi.avcodec.avcodec_parameters_to_context(c_void_p(cctx), c_void_p(par)) < 0:
            return None, None, None, None
        rng = ffi.opt_get_int(cctx, "color_range")
        pri = ffi.opt_get_int(cctx, "color_primaries")
        trc = ffi.opt_get_int(cctx, "color_trc")
        spc = ffi.opt_get_int(cctx, "colorspace")
        return (
            _COLOR_RANGE.get(rng),
            _COLOR_PRIMARIES.get(pri),
            _COLOR_TRC.get(trc),
            _COLOR_SPACE.get(spc),
        )
    finally:
        p = c_void_p(cctx)
        ffi.avcodec.avcodec_free_context(byref(p))


def _profile_name(ffi, codec_id: int, profile: int) -> Optional[str]:
    try:
        fn = ffi.avcodec.avcodec_profile_name
        fn.restype = ffimod.c_char_p
        fn.argtypes = [ffimod.c_int, ffimod.c_int]
        s = fn(codec_id, profile)
        return s.decode() if s else None
    except Exception:
        return None


def probe_video(path) -> VideoInfo:
    """Probe a media file into VideoInfo (reference contract, see module doc)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    try:
        return _probe_ffi(path)
    except FFIUnavailable:
        return _probe_cv2(path)


def _probe_ffi(path: Path) -> VideoInfo:
    ffi = get_ffi()
    f = ffi.avformat
    ctxp = c_void_p(0)
    ffi.check(
        f.avformat_open_input(byref(ctxp), str(path).encode(), None, None),
        "avformat_open_input",
    )
    try:
        ffi.check(f.avformat_find_stream_info(ctxp, None), "find_stream_info")
        ctx = ctxp.value
        info = VideoInfo()
        info.file_size = path.stat().st_size

        ifmt = _r_ptr(ctx, OFF["fmt_iformat"])
        if ifmt:
            namep = _r_ptr(ifmt, 0)
            longp = _r_ptr(ifmt, 8)
            import ctypes as ct

            info.format_name = ct.string_at(namep).decode() if namep else None
            info.format_long_name = ct.string_at(longp).decode() if longp else None

        fmt_duration = None
        if ffi.fmt_duration_off:
            d = _r_i64(ctx, ffi.fmt_duration_off)
            if d not in (0, AV_NOPTS_VALUE) and d > 0:
                fmt_duration = d / AV_TIME_BASE
            br = _r_i64(ctx, ffi.fmt_bit_rate_off)
            if 0 < br < 10**12:
                info.container_bitrate = kbps_string(br)

        decp = c_void_p(0)
        vidx = f.av_find_best_stream(ctx, AVMEDIA_TYPE_VIDEO, -1, -1, byref(decp), 0)
        if vidx >= 0:
            streams = _r_ptr(ctx, OFF["fmt_streams"])
            st = _r_ptr(streams, 8 * vidx)
            par = _r_ptr(st, OFF["st_codecpar"])
            info.width = _r_i32(par, OFF["par_width"]) or None
            info.height = _r_i32(par, OFF["par_height"]) or None
            pix = ffi.pix_fmt_name(_r_i32(par, OFF["par_format"]))
            info.pix_fmt = pix
            codec_id = _r_i32(par, OFF["par_codec_id"])
            info.codec_name = ffi.codec_name(codec_id)
            info.codec_long_name = ffi.codec_long_name(codec_id)
            prof = _r_i32(par, OFF["par_profile"])
            if prof != -99:  # AV_PROFILE_UNKNOWN
                info.profile = _profile_name(ffi, codec_id, prof) or str(prof)
            lvl = _r_i32(par, OFF["par_level"])
            if lvl != -99:
                info.level = str(lvl)
            bprs = _r_i32(par, OFF["par_bits_per_raw_sample"])
            info.bit_depth = infer_bit_depth(pix, bprs if bprs > 0 else None)
            if info.bit_depth is None and pix and pix.startswith(("yuv", "nv", "gray", "rgb", "bgr")):
                # plain 8-bit formats carry no digit suffix and codecs often
                # leave bits_per_raw_sample unset (ffprobe prints 8 there too)
                info.bit_depth = 8
            info.bitrate = kbps_string(_r_i64(par, OFF["par_bit_rate"]))

            sar = _r_rational(st, OFF["st_sar"])
            info.sar = _rational_str(sar)
            if info.sar and info.width and info.height:
                num = info.width * sar.num
                den = info.height * sar.den
                from math import gcd

                g = gcd(num, den) or 1
                info.dar = f"{num // g}:{den // g}"

            afr = _r_rational(st, OFF["st_avg_frame_rate"])
            info.avg_fps = afr.value()
            rfr = f.av_guess_frame_rate(ctx, c_void_p(st), None)
            info.r_fps = rfr.value()
            info.fps = info.avg_fps or info.r_fps
            info.is_vfr = detect_vfr(info.avg_fps, info.r_fps)

            tb = _r_rational(st, OFF["st_time_base"])
            sd = _r_i64(st, OFF["st_duration"])
            if sd not in (0, AV_NOPTS_VALUE) and sd > 0 and tb.den:
                info.duration = sd * tb.num / tb.den
            else:
                info.duration = fmt_duration
            nbf = _r_i64(st, OFF["st_nb_frames"])
            info.nb_frames = nbf if nbf > 0 else None

            rng, pri, trc, spc = _ctx_color_props(ffi, par, decp.value)
            info.color_range = normalize_color(rng)
            info.color_primaries = normalize_color(pri)
            info.color_trc = normalize_color(trc)
            info.colorspace = normalize_color(spc)
            info.video_tags = ffi.dict_items(_r_ptr(st, OFF["st_metadata"])) or None
        else:
            info.duration = fmt_duration

        adecp = c_void_p(0)
        aidx = f.av_find_best_stream(ctx, AVMEDIA_TYPE_AUDIO, -1, -1, byref(adecp), 0)
        if aidx >= 0:
            streams = _r_ptr(ctx, OFF["fmt_streams"])
            ast = _r_ptr(streams, 8 * aidx)
            apar = _r_ptr(ast, OFF["st_codecpar"])
            acid = _r_i32(apar, OFF["par_codec_id"])
            info.audio_codec = ffi.codec_name(acid)
            info.audio_codec_long_name = ffi.codec_long_name(acid)
            info.audio_bitrate = kbps_string(_r_i64(apar, OFF["par_bit_rate"]))
            # sample rate / channels through a decoder ctx's options
            actx = ffi.avcodec.avcodec_alloc_context3(adecp)
            try:
                if ffi.avcodec.avcodec_parameters_to_context(
                    c_void_p(actx), c_void_p(apar)
                ) >= 0:
                    sr = ffi.opt_get_int(actx, "ar")
                    info.audio_sample_rate = int(sr) if sr else None
                    # channel count via ch_layout string (no "ac" AVOption)
                    import ctypes as ct

                    buf = ct.c_void_p(0)
                    if ffi.avutil.av_opt_get(
                        ct.c_void_p(actx), b"ch_layout", 0, ct.byref(buf)
                    ) >= 0 and buf.value:
                        layout = ct.string_at(buf.value).decode()
                        ffi.avutil.av_free(buf)
                        info.audio_channel_layout = layout
                        named = {"mono": 1, "stereo": 2, "2.1": 3, "5.1": 6,
                                 "7.1": 8}
                        if layout in named:
                            info.audio_channels = named[layout]
                        elif layout and layout[0].isdigit():
                            try:
                                info.audio_channels = int(layout.split()[0])
                            except ValueError:
                                pass
            finally:
                p = c_void_p(actx)
                ffi.avcodec.avcodec_free_context(byref(p))
            info.audio_tags = ffi.dict_items(_r_ptr(ast, OFF["st_metadata"])) or None

        # Reference rule: yuvj* implies full range when untagged
        # (media_info.py:145-147).
        if not info.color_range and info.pix_fmt and info.pix_fmt.startswith("yuvj"):
            info.color_range = "pc"
        return info
    finally:
        f.avformat_close_input(byref(ctxp))


def _probe_cv2(path: Path) -> VideoInfo:
    """Degraded fallback when the FFI layer is unusable."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or None
        nframes = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0) or None
        return VideoInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or None,
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or None,
            fps=fps,
            avg_fps=fps,
            r_fps=fps,
            duration=(nframes / fps) if (fps and nframes) else None,
            nb_frames=nframes,
            file_size=path.stat().st_size,
        )
    finally:
        cap.release()
