"""ctypes binding over the bundled FFmpeg 62.x shared libraries.

No FFmpeg headers exist in this environment, so the binding works from three
principles:

1. **Functions only need prototypes** — declared here from the stable public
   API (names are versioned exports of the bundled .so files).
2. **Struct field writes/reads go through AVOptions** wherever possible:
   AVCodecContext/AVFormatContext are AVClass objects, so `av_opt_set(ctx,
   "video_size", "3840x2160", 0)` & co. replace direct field access with the
   library's own offset table (verified live: 322 options on prores_ks ctx).
3. **The few raw offsets we do need (AVFrame, AVPacket, AVStream,
   AVFormatContext, AVCodecParameters leading fields) are runtime-verified**:
   `verify_layout()` writes a known synthetic clip, opens it through the
   binding, and asserts every offset against known ground truth (320x240,
   25 fps, 50 frames, yuv420p, mpeg4) before the layer is considered usable.
   A failed check raises FFIUnavailable and callers degrade to cv2 paths.

The libraries are the ones an opencv-python wheel bundles (the full or the
headless wheel). libavfilter is optional: the headless wheel leaves it out.
The lut3d oracle and every audio re-encode (`-c:a aac` and the other
non-copy audio codecs) need it; without it the policy preflight notes that
the audio stream is copied instead (plan/policy.py).

This is the rebuild's equivalent of the reference's L0 native engine
boundary (SURVEY.md layer map), implemented in-process instead of via argv.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading
from ctypes import (
    POINTER, Structure, byref, c_char_p, c_double, c_int, c_int64, c_size_t,
    c_uint8, c_void_p, cast,
)
from pathlib import Path
from typing import Optional

AV_NOPTS_VALUE = -0x8000000000000000
AVMEDIA_TYPE_VIDEO = 0
AVMEDIA_TYPE_AUDIO = 1
AVERROR_EAGAIN = -11
AVERROR_EOF = -541478725  # FFERRTAG('E','O','F',' ')
AVIO_FLAG_WRITE = 2
AV_OPT_SEARCH_CHILDREN = 1
AV_TIME_BASE = 1_000_000

# Pixel format enums (libavutil/pixfmt.h — public, stable by append-only rule)
PIX_FMT = {
    "yuv420p": 0, "yuyv422": 1, "rgb24": 2, "bgr24": 3, "yuv422p": 4,
    "yuv444p": 5, "yuv410p": 6, "yuv411p": 7, "gray": 8, "monow": 9,
    "monob": 10, "pal8": 11, "yuvj420p": 12, "yuvj422p": 13, "yuvj444p": 14,
}
# Name->id beyond the leading block resolved via av_get_pix_fmt at runtime.


class Rational(Structure):
    _fields_ = [("num", c_int), ("den", c_int)]

    def value(self) -> Optional[float]:
        return self.num / self.den if self.den else None

    def __repr__(self):
        return f"{self.num}/{self.den}"


class FFIUnavailable(RuntimeError):
    """The binding itself is unusable (missing libs / layout mismatch)."""


class MediaError(RuntimeError):
    """A specific file/stream operation failed (bad media, codec error)."""


def _libdir() -> str:
    """The bundled-library directory of the installed opencv wheel
    (opencv_python.libs, opencv_python_headless.libs, ...)."""
    import cv2

    site = os.path.join(os.path.dirname(cv2.__file__), "..")
    dirs = sorted(glob.glob(os.path.join(site, "opencv*.libs")))
    if not dirs:
        raise FFIUnavailable(f"no opencv*.libs directory beside {cv2.__file__}")
    return os.path.abspath(dirs[0])


# Raw struct offsets (x86-64). Every one of these is asserted by
# verify_layout() before use; see module docstring.
OFF = dict(
    # AVFrame (libavutil 60): data[8], linesize[8], extended_data, width,
    # height, nb_samples, format, pict_type, sample_aspect_ratio, pts, pkt_dts
    frame_data=0,
    frame_linesize=64,
    frame_width=104,
    frame_height=108,
    frame_nb_samples=112,
    frame_format=116,
    frame_pts=136,
    frame_pkt_dts=144,
    # AVPacket: buf, pts, dts, data, size, stream_index, flags, side_data,
    # side_data_elems, duration
    pkt_pts=8,
    pkt_dts=16,
    pkt_data=24,
    pkt_size=32,
    pkt_stream_index=36,
    pkt_flags=40,
    pkt_duration=64,
    # AVStream: av_class, index, id, codecpar, priv_data, time_base,
    # start_time, duration, nb_frames, disposition, discard, SAR, metadata,
    # avg_frame_rate
    st_index=8,
    st_id=12,
    st_codecpar=16,
    st_time_base=32,
    st_duration=48,
    st_nb_frames=56,
    st_sar=72,
    st_metadata=80,
    st_avg_frame_rate=88,
    # AVFormatContext: av_class, iformat, oformat, priv_data, pb, ctx_flags,
    # nb_streams, streams (duration/bit_rate offsets discovered at runtime)
    fmt_iformat=8,
    fmt_oformat=16,
    fmt_priv_data=24,
    fmt_pb=32,
    fmt_nb_streams=44,
    fmt_streams=48,
    # AVCodecParameters: codec_type, codec_id, codec_tag, extradata,
    # extradata_size, coded_side_data, nb_coded_side_data, format,
    # bit_rate, bits_per_coded_sample, bits_per_raw_sample, profile, level,
    # width, height, sample_aspect_ratio, framerate?, field_order,
    # color_range, color_primaries, color_trc, color_space, chroma_location
    par_codec_type=0,
    par_codec_id=4,
    par_format=44,
    par_bit_rate=48,
    par_bits_per_raw_sample=60,
    par_profile=64,
    par_level=68,
    par_width=72,
    par_height=76,
)


def _r_i32(p, off) -> int:
    return cast(p + off, POINTER(c_int)).contents.value


def _r_i64(p, off) -> int:
    return cast(p + off, POINTER(c_int64)).contents.value


def _r_ptr(p, off) -> int:
    return cast(p + off, POINTER(c_void_p)).contents.value or 0


def _w_i32(p, off, v) -> None:
    cast(p + off, POINTER(c_int)).contents.value = v


def _w_i64(p, off, v) -> None:
    cast(p + off, POINTER(c_int64)).contents.value = v


def _r_rational(p, off) -> Rational:
    return Rational.from_address(p + off)


class FFmpegFFI:
    """Loaded + layout-verified FFmpeg binding. Use get_ffi()."""

    def __init__(self):
        d = _libdir()

        def load(pat):
            paths = glob.glob(os.path.join(d, pat))
            if not paths:
                raise FFIUnavailable(f"missing {pat} in {d}")
            return ctypes.CDLL(paths[0], mode=ctypes.RTLD_GLOBAL)

        self.avutil = load("libavutil-*.so*")
        self.swresample = load("libswresample-*.so*")
        self.avcodec = load("libavcodec-*.so*")
        self.avformat = load("libavformat-*.so*")
        self.swscale = load("libswscale-*.so*")
        try:
            self._avfilter = load("libavfilter-*.so*")
            self._avfilter_error = None
        except FFIUnavailable as exc:
            self._avfilter, self._avfilter_error = None, exc
        self._declare()
        # Discovered at verify time:
        self.fmt_duration_off: Optional[int] = None
        self.fmt_bit_rate_off: Optional[int] = None
        self._verified = False

    @property
    def has_avfilter(self) -> bool:
        return self._avfilter is not None

    @property
    def avfilter(self):
        """libavfilter; raises FFIUnavailable where the wheel lacks it."""
        if self._avfilter is None:
            raise self._avfilter_error
        return self._avfilter

    # -- prototypes ---------------------------------------------------------
    def _declare(self):
        u, c, f = self.avutil, self.avcodec, self.avformat

        u.av_frame_alloc.restype = c_void_p
        u.av_frame_free.argtypes = [POINTER(c_void_p)]
        u.av_frame_unref.argtypes = [c_void_p]
        u.av_frame_get_buffer.argtypes = [c_void_p, c_int]
        u.av_frame_get_buffer.restype = c_int
        u.av_frame_make_writable.argtypes = [c_void_p]
        u.av_frame_make_writable.restype = c_int
        u.av_opt_set.argtypes = [c_void_p, c_char_p, c_char_p, c_int]
        u.av_opt_set.restype = c_int
        u.av_opt_get.argtypes = [c_void_p, c_char_p, c_int, POINTER(c_void_p)]
        u.av_opt_get.restype = c_int
        u.av_opt_set_int.argtypes = [c_void_p, c_char_p, c_int64, c_int]
        u.av_opt_set_int.restype = c_int
        u.av_opt_get_int.argtypes = [c_void_p, c_char_p, c_int, POINTER(c_int64)]
        u.av_opt_get_int.restype = c_int
        u.av_get_pix_fmt.argtypes = [c_char_p]
        u.av_get_pix_fmt.restype = c_int
        u.av_get_pix_fmt_name.argtypes = [c_int]
        u.av_get_pix_fmt_name.restype = c_char_p
        u.av_strerror.argtypes = [c_int, c_char_p, c_size_t]
        u.av_dict_get.argtypes = [c_void_p, c_char_p, c_void_p, c_int]
        u.av_dict_get.restype = c_void_p
        u.av_free.argtypes = [c_void_p]
        u.av_freep.argtypes = [c_void_p]
        u.av_rescale_q.argtypes = [c_int64, Rational, Rational]
        u.av_rescale_q.restype = c_int64

        c.avcodec_alloc_context3.argtypes = [c_void_p]
        c.avcodec_alloc_context3.restype = c_void_p
        c.avcodec_free_context.argtypes = [POINTER(c_void_p)]
        c.avcodec_parameters_to_context.argtypes = [c_void_p, c_void_p]
        c.avcodec_parameters_to_context.restype = c_int
        c.avcodec_parameters_from_context.argtypes = [c_void_p, c_void_p]
        c.avcodec_parameters_from_context.restype = c_int
        c.avcodec_parameters_copy.argtypes = [c_void_p, c_void_p]
        c.avcodec_parameters_copy.restype = c_int
        c.avcodec_open2.argtypes = [c_void_p, c_void_p, c_void_p]
        c.avcodec_open2.restype = c_int
        c.avcodec_send_packet.argtypes = [c_void_p, c_void_p]
        c.avcodec_send_packet.restype = c_int
        c.avcodec_receive_frame.argtypes = [c_void_p, c_void_p]
        c.avcodec_receive_frame.restype = c_int
        c.avcodec_send_frame.argtypes = [c_void_p, c_void_p]
        c.avcodec_send_frame.restype = c_int
        c.avcodec_receive_packet.argtypes = [c_void_p, c_void_p]
        c.avcodec_receive_packet.restype = c_int
        c.avcodec_find_encoder_by_name.argtypes = [c_char_p]
        c.avcodec_find_encoder_by_name.restype = c_void_p
        c.avcodec_find_decoder_by_name.argtypes = [c_char_p]
        c.avcodec_find_decoder_by_name.restype = c_void_p
        c.avcodec_find_decoder.argtypes = [c_int]
        c.avcodec_find_decoder.restype = c_void_p
        c.avcodec_get_name.argtypes = [c_int]
        c.avcodec_get_name.restype = c_char_p
        c.avcodec_descriptor_get.argtypes = [c_int]
        c.avcodec_descriptor_get.restype = c_void_p
        c.av_packet_alloc.restype = c_void_p
        c.av_packet_free.argtypes = [POINTER(c_void_p)]
        c.av_packet_unref.argtypes = [c_void_p]
        c.av_packet_rescale_ts.argtypes = [c_void_p, Rational, Rational]

        f.avformat_open_input.argtypes = [POINTER(c_void_p), c_char_p, c_void_p, c_void_p]
        f.avformat_open_input.restype = c_int
        f.avformat_close_input.argtypes = [POINTER(c_void_p)]
        f.avformat_find_stream_info.argtypes = [c_void_p, c_void_p]
        f.avformat_find_stream_info.restype = c_int
        f.av_find_best_stream.argtypes = [c_void_p, c_int, c_int, c_int, POINTER(c_void_p), c_int]
        f.av_find_best_stream.restype = c_int
        f.av_read_frame.argtypes = [c_void_p, c_void_p]
        f.av_read_frame.restype = c_int
        f.av_seek_frame.argtypes = [c_void_p, c_int, c_int64, c_int]
        f.av_seek_frame.restype = c_int
        f.avformat_alloc_output_context2.argtypes = [POINTER(c_void_p), c_void_p, c_char_p, c_char_p]
        f.avformat_alloc_output_context2.restype = c_int
        f.avformat_free_context.argtypes = [c_void_p]
        f.avformat_new_stream.argtypes = [c_void_p, c_void_p]
        f.avformat_new_stream.restype = c_void_p
        f.avformat_write_header.argtypes = [c_void_p, c_void_p]
        f.avformat_write_header.restype = c_int
        f.av_interleaved_write_frame.argtypes = [c_void_p, c_void_p]
        f.av_interleaved_write_frame.restype = c_int
        f.av_write_trailer.argtypes = [c_void_p]
        f.av_write_trailer.restype = c_int
        f.avio_open.argtypes = [POINTER(c_void_p), c_char_p, c_int]
        f.avio_open.restype = c_int
        f.avio_closep.argtypes = [POINTER(c_void_p)]
        f.avio_closep.restype = c_int
        f.av_guess_frame_rate.argtypes = [c_void_p, c_void_p, c_void_p]
        f.av_guess_frame_rate.restype = Rational

    # -- helpers ------------------------------------------------------------
    def err(self, code: int) -> str:
        buf = ctypes.create_string_buffer(256)
        self.avutil.av_strerror(code, buf, 256)
        return buf.value.decode(errors="replace")

    def check(self, code: int, what: str) -> int:
        if code < 0:
            raise MediaError(f"{what} failed: {self.err(code)} ({code})")
        return code

    def opt_set(self, obj: int, name: str, value: str,
                search_children: bool = True) -> int:
        return self.avutil.av_opt_set(
            c_void_p(obj), name.encode(), value.encode(),
            AV_OPT_SEARCH_CHILDREN if search_children else 0,
        )

    def opt_get_int(self, obj: int, name: str) -> Optional[int]:
        out = c_int64(0)
        r = self.avutil.av_opt_get_int(
            c_void_p(obj), name.encode(), AV_OPT_SEARCH_CHILDREN, byref(out)
        )
        return out.value if r >= 0 else None

    def pix_fmt_id(self, name: str) -> int:
        return self.avutil.av_get_pix_fmt(name.encode())

    def pix_fmt_name(self, fmt: int) -> Optional[str]:
        s = self.avutil.av_get_pix_fmt_name(fmt)
        return s.decode() if s else None

    def codec_name(self, codec_id: int) -> Optional[str]:
        s = self.avcodec.avcodec_get_name(codec_id)
        return s.decode() if s else None

    def codec_long_name(self, codec_id: int) -> Optional[str]:
        # AVCodecDescriptor: {id, type, name, long_name, ...} — stable layout.
        d = self.avcodec.avcodec_descriptor_get(codec_id)
        if not d:
            return None
        p = _r_ptr(d, 16)
        return ctypes.string_at(p).decode() if p else None

    def dict_items(self, dict_ptr: int) -> dict:
        """Iterate an AVDictionary: entries are {char* key; char* value}."""
        items = {}
        if not dict_ptr:
            return items
        prev = c_void_p(0)
        while True:
            e = self.avutil.av_dict_get(
                c_void_p(dict_ptr), b"", prev, 2  # AV_DICT_IGNORE_SUFFIX
            )
            if not e:
                break
            key = ctypes.string_at(_r_ptr(e, 0)).decode(errors="replace")
            val = ctypes.string_at(_r_ptr(e, 8)).decode(errors="replace")
            items[key] = val
            prev = c_void_p(e)
        return items

    # -- layout verification ------------------------------------------------
    def verify_layout(self, fixture_path: Optional[str] = None) -> None:
        """Assert every raw offset against a clip with known properties."""
        if self._verified:
            return
        import tempfile

        own_fixture = fixture_path is None
        if own_fixture:
            from ..utils.fixtures import make_gradient_clip

            tmp = Path(tempfile.mkdtemp(prefix="luttpu_ffi_")) / "probe.mp4"
            make_gradient_clip(tmp, 320, 240, fps=25.0, frames=50)
            fixture_path = str(tmp)

        f = self.avformat
        ctxp = c_void_p(0)
        self.check(
            f.avformat_open_input(byref(ctxp), fixture_path.encode(), None, None),
            "avformat_open_input",
        )
        try:
            self.check(f.avformat_find_stream_info(ctxp, None), "find_stream_info")
            ctx = ctxp.value
            nb = _r_i32(ctx, OFF["fmt_nb_streams"])
            if nb != 1:
                raise FFIUnavailable(f"layout check: nb_streams={nb}, want 1")
            streams = _r_ptr(ctx, OFF["fmt_streams"])
            st = _r_ptr(streams, 0)
            if _r_i32(st, OFF["st_index"]) != 0:
                raise FFIUnavailable("layout check: stream index != 0")
            par = _r_ptr(st, OFF["st_codecpar"])
            if _r_i32(par, OFF["par_codec_type"]) != AVMEDIA_TYPE_VIDEO:
                raise FFIUnavailable("layout check: codecpar codec_type")
            w = _r_i32(par, OFF["par_width"])
            h = _r_i32(par, OFF["par_height"])
            if (w, h) != (320, 240):
                # Try to locate (320,240) to aid debugging before failing.
                found = None
                for off in range(0, 256, 4):
                    if _r_i32(par, off) == 320 and _r_i32(par, off + 4) == 240:
                        found = off
                        break
                raise FFIUnavailable(
                    f"layout check: codecpar w/h=({w},{h}) at {OFF['par_width']}; "
                    f"(320,240) actually at {found}"
                )
            if _r_i32(par, OFF["par_format"]) != 0:  # AV_PIX_FMT_YUV420P
                raise FFIUnavailable("layout check: codecpar format != yuv420p")
            tb = _r_rational(st, OFF["st_time_base"])
            if not (tb.num > 0 and tb.den > 0 and tb.den >= tb.num):
                raise FFIUnavailable(f"layout check: stream time_base {tb}")
            afr = _r_rational(st, OFF["st_avg_frame_rate"])
            if afr.den and abs(afr.num / afr.den - 25.0) > 0.2:
                raise FFIUnavailable(f"layout check: avg_frame_rate {afr}")
            nbf = _r_i64(st, OFF["st_nb_frames"])
            if nbf not in (0, 50):
                raise FFIUnavailable(f"layout check: nb_frames {nbf}")

            # Discover AVFormatContext duration/bit_rate offsets: scan int64s
            # for the known 2.0 s duration in AV_TIME_BASE units.
            want = 2 * AV_TIME_BASE
            for off in range(56, 256, 8):
                v = _r_i64(ctx, off)
                if abs(v - want) < AV_TIME_BASE // 10:
                    self.fmt_duration_off = off
                    self.fmt_bit_rate_off = off + 8
                    break
            # Non-fatal if absent: stream duration still works.

            # AVFrame/AVPacket checks: decode first frame.
            decp = c_void_p(0)
            vidx = self.check(
                f.av_find_best_stream(ctx, AVMEDIA_TYPE_VIDEO, -1, -1, byref(decp), 0),
                "find_best_stream",
            )
            cctx = self.avcodec.avcodec_alloc_context3(decp)
            try:
                self.check(
                    self.avcodec.avcodec_parameters_to_context(c_void_p(cctx), c_void_p(par)),
                    "parameters_to_context",
                )
                self.check(self.avcodec.avcodec_open2(c_void_p(cctx), decp, None), "open2")
                pkt = self.avcodec.av_packet_alloc()
                frm = self.avutil.av_frame_alloc()
                got = False
                try:
                    while not got:
                        r = f.av_read_frame(ctx, c_void_p(pkt))
                        if r < 0:
                            break
                        if _r_i32(pkt, OFF["pkt_stream_index"]) != vidx:
                            self.avcodec.av_packet_unref(c_void_p(pkt))
                            continue
                        if _r_i32(pkt, OFF["pkt_size"]) <= 0:
                            raise FFIUnavailable("layout check: pkt size <= 0")
                        self.check(
                            self.avcodec.avcodec_send_packet(c_void_p(cctx), c_void_p(pkt)),
                            "send_packet",
                        )
                        self.avcodec.av_packet_unref(c_void_p(pkt))
                        r = self.avcodec.avcodec_receive_frame(c_void_p(cctx), c_void_p(frm))
                        if r == AVERROR_EAGAIN:
                            continue
                        self.check(r, "receive_frame")
                        got = True
                    if not got:
                        raise FFIUnavailable("layout check: no frame decoded")
                    fw = _r_i32(frm, OFF["frame_width"])
                    fh = _r_i32(frm, OFF["frame_height"])
                    if (fw, fh) != (320, 240):
                        raise FFIUnavailable(f"layout check: frame w/h ({fw},{fh})")
                    if _r_i32(frm, OFF["frame_format"]) != 0:
                        raise FFIUnavailable("layout check: frame format")
                    if not _r_ptr(frm, OFF["frame_data"]):
                        raise FFIUnavailable("layout check: frame data[0] null")
                    ls0 = _r_i32(frm, OFF["frame_linesize"])
                    if not (320 <= ls0 <= 1024):
                        raise FFIUnavailable(f"layout check: linesize {ls0}")
                    pts = _r_i64(frm, OFF["frame_pts"])
                    if pts not in (0, AV_NOPTS_VALUE):
                        # first decoded frame of our fixture starts at 0
                        raise FFIUnavailable(f"layout check: first pts {pts}")
                finally:
                    pktp = c_void_p(pkt)
                    frmp = c_void_p(frm)
                    self.avcodec.av_packet_free(byref(pktp))
                    self.avutil.av_frame_free(byref(frmp))
            finally:
                cctxp = c_void_p(cctx)
                self.avcodec.avcodec_free_context(byref(cctxp))
        finally:
            f.avformat_close_input(byref(ctxp))
        self._verified = True


_FFI: Optional[FFmpegFFI] = None
_FFI_ERR: Optional[Exception] = None
_LOCK = threading.Lock()


def get_ffi(verify: bool = True) -> FFmpegFFI:
    """Singleton loaded+verified binding; raises FFIUnavailable on failure."""
    global _FFI, _FFI_ERR
    with _LOCK:
        if _FFI_ERR is not None:
            raise FFIUnavailable(str(_FFI_ERR))
        if _FFI is None:
            try:
                _FFI = FFmpegFFI()
            except Exception as exc:
                _FFI_ERR = exc
                raise FFIUnavailable(str(exc)) from exc
        if verify and not _FFI._verified:
            try:
                _FFI.verify_layout()
            except Exception as exc:
                _FFI_ERR = exc
                _FFI = None
                raise FFIUnavailable(str(exc)) from exc
        return _FFI
