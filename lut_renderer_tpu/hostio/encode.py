"""In-process video encoding + muxing via the bundled libavcodec/libavformat.

Replaces the encode half of the reference's external FFmpeg process. Carries
the policy engine's encoder settings (bitrate/maxrate/bufsize, GOP, profile,
level, threads, color tags, faststart — semantics of src/lut_renderer/
ffmpeg.py:304-411) onto a real encoder context through AVOptions.

Encoder availability in the bundled libs (measured): prores_ks / prores /
prores_aw, mpeg4, libvpx-vp9, ffv1, mjpeg, png, aac, pcm_*. libx264/libx265
are NOT bundled (decode-only h264/hevc) — requesting them raises
EncoderUnavailable, and the task layer reports it exactly like the reference
reports a failed FFmpeg run (no pre-flight availability check; readme.md:117).
"""

from __future__ import annotations

import re
from ctypes import byref, c_void_p, memmove
from dataclasses import dataclass, field
from fractions import Fraction
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .ffi import (
    AVERROR_EAGAIN,
    AVERROR_EOF,
    AVIO_FLAG_WRITE,
    AVMEDIA_TYPE_AUDIO,
    OFF,
    Rational,
    _r_i32,
    _r_i64,
    _r_ptr,
    _r_rational,
    _w_i32,
    _w_i64,
    get_ffi,
)

_BITRATE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)([kKmMgG]?)\s*$")


class EncoderUnavailable(RuntimeError):
    pass


def bitrate_to_bits(value: Optional[str]) -> Optional[int]:
    if not value:
        return None
    m = _BITRATE_RE.match(value)
    if not m:
        return None
    num = float(m.group(1))
    mul = {"": 1, "k": 1_000, "m": 1_000_000, "g": 1_000_000_000}[m.group(2).lower()]
    return int(num * mul)


def encoder_pix_fmts(codec_name: str) -> List[str]:
    """Supported pixel formats of an encoder, preference order first.

    Uses avcodec_get_supported_config (lavc 62 API); replaces the implicit
    format negotiation FFmpeg's CLI performs when no -pix_fmt is given.
    """
    import ctypes as ct

    ffi = get_ffi(verify=False)
    enc = ffi.avcodec.avcodec_find_encoder_by_name(codec_name.encode())
    if not enc:
        return []
    fn = ffi.avcodec.avcodec_get_supported_config
    fn.argtypes = [c_void_p, c_void_p, ct.c_int, ct.c_uint,
                   ct.POINTER(c_void_p), ct.POINTER(ct.c_int)]
    fn.restype = ct.c_int
    out = c_void_p(0)
    count = ct.c_int(0)
    # AV_CODEC_CONFIG_PIX_FORMAT == 0
    if fn(None, enc, 0, 0, byref(out), byref(count)) < 0 or not out.value:
        return []
    arr = ct.cast(out.value, ct.POINTER(ct.c_int))
    names = []
    for i in range(count.value):
        nm = ffi.pix_fmt_name(arr[i])
        if nm:
            names.append(nm)
    return names


def pick_encoder_pix_fmt(codec_name: str, depth: int, subsampling: str) -> Optional[str]:
    """Choose the closest supported encoder format to (depth, subsampling);
    falls back to the encoder's first/preferred format."""
    fmts = encoder_pix_fmts(codec_name)
    if not fmts:
        return None
    want = f"yuv{subsampling}p" + ("" if depth <= 8 else f"{depth}le")
    if want in fmts:
        return want
    # same depth, any subsampling
    tag = "" if depth <= 8 else f"{depth}le"
    for f in fmts:
        if f.startswith("yuv") and f.endswith("p" + tag if tag else "p"):
            return f
    return fmts[0]


def list_encoders(candidates=None) -> List[str]:
    ffi = get_ffi(verify=False)
    names = candidates or [
        # video (the reference's menu, main_window.py:748-760, plus bundled
        # pro-mastering codecs verified end-to-end in tests/test_encoders_ext)
        "prores_ks", "prores", "prores_aw", "libx264", "libx265", "mpeg4",
        "libvpx-vp9", "libvpx", "dnxhd", "cfhd", "v210", "mpeg2video",
        "utvideo", "ffv1", "mjpeg", "png",
        # audio (reference offers aac/mp3/copy; the bundled libs add these)
        "aac", "flac", "alac", "ac3", "eac3", "mp2", "opus", "vorbis",
        "mp3", "pcm_s16le",
    ]
    return [n for n in names if ffi.avcodec.avcodec_find_encoder_by_name(n.encode())]


def encoder_available(name: str) -> bool:
    """Whether the bundled libavcodec ships an encoder named `name` (video
    or audio — e.g. 'mp3' is offered by the reference UI but absent from
    these libs; the policy layer notes the copy degradation)."""
    try:
        ffi = get_ffi(verify=False)
    except Exception:
        return False
    return bool(ffi.avcodec.avcodec_find_encoder_by_name(name.encode()))


def audio_reencode_available() -> bool:
    """Whether audio can be re-encoded at all: the transcode's resample and
    re-frame graph needs libavfilter, which the headless opencv wheel's
    FFmpeg build leaves out. Without it the encoder copies the audio stream
    and the policy layer notes the degradation."""
    try:
        return get_ffi(verify=False).has_avfilter
    except Exception:
        return False


@dataclass
class EncoderSettings:
    codec: str
    width: int
    height: int
    pix_fmt: str
    fps: Fraction                      # output frame rate (time_base = 1/fps)
    bitrate: Optional[str] = None
    maxrate: Optional[str] = None
    bufsize: Optional[str] = None
    gop: Optional[int] = None
    profile: Optional[str] = None
    level: Optional[str] = None
    threads: Optional[str] = None
    qscale: Optional[int] = None       # for mpeg4/mjpeg-style rate control
    crf: Optional[int] = None          # native CRF (libvpx-vp9, 0-63)
    color_primaries: Optional[str] = None
    color_trc: Optional[str] = None
    colorspace: Optional[str] = None
    color_range: Optional[str] = None
    faststart: bool = False
    extra_opts: dict = field(default_factory=dict)


@dataclass
class _AudioCopy:
    packets: List[Tuple[bytes, int, int, int, int]]  # data, pts, dts, duration, flags
    src_time_base: Tuple[int, int]
    out_stream_index: int
    out_st: int


class VideoEncoder:
    """Encode planar YUV frames to a container file, optionally remuxing the
    audio stream of `audio_from` with codec copy (the reference's pro-master
    behavior, ffmpeg.py:420 audio copy)."""

    def __init__(self, path, settings: EncoderSettings,
                 audio_from: Optional[Path] = None,
                 audio_mode: str = "copy",
                 audio_bitrate: Optional[str] = None,
                 audio_sample_rate: Optional[int] = None,
                 audio_channels: Optional[int] = None):
        self._audio_mode = audio_mode
        self._audio_bitrate = audio_bitrate
        self._audio_sample_rate = audio_sample_rate
        self._audio_channels = audio_channels
        self.path = Path(path)
        self.settings = settings
        self.ffi = get_ffi()
        ffi = self.ffi
        enc = ffi.avcodec.avcodec_find_encoder_by_name(settings.codec.encode())
        if not enc:
            raise EncoderUnavailable(
                f"encoder {settings.codec!r} not available in bundled libavcodec"
            )

        self._ofmt = c_void_p(0)
        ffi.check(
            ffi.avformat.avformat_alloc_output_context2(
                byref(self._ofmt), None, None, str(self.path).encode()
            ),
            "alloc_output_context2",
        )
        self._closed = False
        self._header = False
        try:
            self._st = ffi.avformat.avformat_new_stream(self._ofmt, None)
            if not self._st:
                raise EncoderUnavailable("avformat_new_stream failed")
            self._ctx = ffi.avcodec.avcodec_alloc_context3(c_void_p(enc))

            s = settings
            tb = f"{s.fps.denominator}/{s.fps.numerator}"
            opts = {
                "video_size": f"{s.width}x{s.height}",
                "pixel_format": s.pix_fmt,
                "time_base": tb,
            }
            if s.bitrate:
                opts["b"] = str(bitrate_to_bits(s.bitrate) or 0)
            if s.maxrate:
                opts["maxrate"] = str(bitrate_to_bits(s.maxrate) or 0)
            if s.bufsize:
                opts["bufsize"] = str(bitrate_to_bits(s.bufsize) or 0)
            if s.gop is not None:
                opts["g"] = str(s.gop)
            if s.profile:
                opts["profile"] = s.profile
            if s.level:
                opts["level"] = s.level
            # the ffmpeg binary auto-threads encoders by default; a raw
            # libavcodec context does not (thread_count=1) — match the
            # reference's effective behavior unless the user pins a count
            opts["threads"] = s.threads if s.threads else "auto"
            if s.color_primaries:
                opts["color_primaries"] = s.color_primaries
            if s.color_trc:
                opts["color_trc"] = s.color_trc
            if s.colorspace:
                opts["colorspace"] = s.colorspace
            if s.color_range:
                opts["color_range"] = s.color_range
            if s.crf is not None:
                # Native CRF (libvpx-vp9): the encoder's own `crf` AVOption
                # on its 0-63 quantizer scale. Without a target bitrate,
                # b=0 selects libvpx constant-quality mode (the ffmpeg CLI
                # equivalent of `-crf N -b:v 0`); with one it is libvpx
                # constrained quality, matching -crf/-b:v passthrough.
                opts["crf"] = str(s.crf)
                if not s.bitrate:
                    opts["b"] = "0"
            if s.qscale is not None:
                # Constant-quantizer via the ratecontrol clamp: qmin==qmax
                # pins every frame's quantizer. (FLAG_QSCALE+global_quality
                # on the context is NOT honored by the mpeg4 encoder — it
                # reads per-frame AVFrame.quality, which this ctypes layer
                # does not poke; verified by the size-ordering test.)
                opts["qmin"] = str(s.qscale)
                opts["qmax"] = str(s.qscale)
            opts.update(s.extra_opts)
            for k, v in opts.items():
                r = ffi.opt_set(self._ctx, k, str(v))
                if r < 0 and k in ("video_size", "pixel_format", "time_base"):
                    ffi.check(r, f"set {k}={v}")

            ffi.check(
                ffi.avcodec.avcodec_open2(c_void_p(self._ctx), c_void_p(enc), None),
                f"open encoder {s.codec}",
            )
            par = _r_ptr(self._st, OFF["st_codecpar"])
            ffi.check(
                ffi.avcodec.avcodec_parameters_from_context(
                    c_void_p(par), c_void_p(self._ctx)
                ),
                "parameters_from_context",
            )
            # hint the muxer with our time base (it may adjust at write_header)
            st_tb = _r_rational(self._st, OFF["st_time_base"])
            st_tb.num, st_tb.den = s.fps.denominator, s.fps.numerator

            self._audio = self._setup_audio_copy(audio_from) if audio_from else None

            if s.faststart:
                ffi.opt_set(self._ofmt.value, "movflags", "+faststart")
            pb = c_void_p(0)
            ffi.check(
                ffi.avformat.avio_open(byref(pb), str(self.path).encode(), AVIO_FLAG_WRITE),
                f"open output {self.path}",
            )
            cast_ok = memmove(self._ofmt.value + OFF["fmt_pb"],
                              byref(pb), 8)
            ffi.check(
                ffi.avformat.avformat_write_header(self._ofmt, None), "write_header"
            )
            self._header = True
            # muxer-final stream time base for packet rescale
            self._st_tb = _r_rational(self._st, OFF["st_time_base"])
            self._enc_tb = Rational(s.fps.denominator, s.fps.numerator)
            self._pkt = ffi.avcodec.av_packet_alloc()
            self._frm = ffi.avutil.av_frame_alloc()
            _w_i32(self._frm, OFF["frame_width"], s.width)
            _w_i32(self._frm, OFF["frame_height"], s.height)
            fmt_id = ffi.pix_fmt_id(s.pix_fmt)
            if fmt_id < 0:
                raise EncoderUnavailable(f"unknown pix_fmt {s.pix_fmt}")
            _w_i32(self._frm, OFF["frame_format"], fmt_id)
            ffi.check(
                ffi.avutil.av_frame_get_buffer(c_void_p(self._frm), 0),
                "frame_get_buffer",
            )
            self._findex = 0
            self._itemsize = 2 if "10le" in s.pix_fmt or "12le" in s.pix_fmt or "16le" in s.pix_fmt else 1
            cws = 1 if ("420" in s.pix_fmt or "422" in s.pix_fmt) else 0
            chs = 1 if "420" in s.pix_fmt else 0
            self._chroma_size = (-(-s.height >> chs) if chs else s.height,
                                 -(-s.width >> cws) if cws else s.width)
        except Exception:
            self._abort()
            raise

    # -- audio --------------------------------------------------------------
    def _setup_audio_copy(self, src: Path) -> Optional[_AudioCopy]:
        if (self._audio_mode not in ("", "copy", None)
                and self.ffi.has_avfilter):
            transcoded = self._setup_audio_transcode(src)
            if transcoded is not None:
                return transcoded
        # copy mode, no libavfilter, a missing encoder or shapes it cannot
        # take: stream copy (the policy preflight notes a missing
        # libavfilter or encoder)
        ffi = self.ffi
        f = ffi.avformat
        ictx = c_void_p(0)
        if f.avformat_open_input(byref(ictx), str(src).encode(), None, None) < 0:
            return None
        try:
            if f.avformat_find_stream_info(ictx, None) < 0:
                return None
            aidx = f.av_find_best_stream(ictx, AVMEDIA_TYPE_AUDIO, -1, -1, None, 0)
            if aidx < 0:
                return None
            streams = _r_ptr(ictx.value, OFF["fmt_streams"])
            ast = _r_ptr(streams, 8 * aidx)
            apar = _r_ptr(ast, OFF["st_codecpar"])
            out_st = f.avformat_new_stream(self._ofmt, None)
            if not out_st:
                return None
            opar = _r_ptr(out_st, OFF["st_codecpar"])
            if ffi.avcodec.avcodec_parameters_copy(c_void_p(opar), c_void_p(apar)) < 0:
                return None
            # container-specific codec_tag (e.g. WAVE fmt tags) must not leak
            # across muxers; ffmpeg's CLI zeroes it on stream copy too.
            _w_i32(opar, 8, 0)
            src_tb = _r_rational(ast, OFF["st_time_base"])
            otb = _r_rational(out_st, OFF["st_time_base"])
            otb.num, otb.den = src_tb.num, src_tb.den
            out_index = _r_i32(out_st, OFF["st_index"])

            import ctypes as ct

            pkt = ffi.avcodec.av_packet_alloc()
            packets = []
            try:
                while f.av_read_frame(ictx, c_void_p(pkt)) >= 0:
                    if _r_i32(pkt, OFF["pkt_stream_index"]) == aidx:
                        size = _r_i32(pkt, OFF["pkt_size"])
                        data = ct.string_at(_r_ptr(pkt, OFF["pkt_data"]), size)
                        packets.append(
                            (
                                data,
                                _r_i64(pkt, OFF["pkt_pts"]),
                                _r_i64(pkt, OFF["pkt_dts"]),
                                _r_i64(pkt, OFF["pkt_duration"]),
                                _r_i32(pkt, OFF["pkt_flags"]),
                            )
                        )
                    ffi.avcodec.av_packet_unref(c_void_p(pkt))
            finally:
                p = c_void_p(pkt)
                ffi.avcodec.av_packet_free(byref(p))
            return _AudioCopy(
                packets=packets,
                src_time_base=(src_tb.num, src_tb.den),
                out_stream_index=out_index,
                out_st=out_st,
            )
        finally:
            f.avformat_close_input(byref(ictx))

    def _setup_audio_transcode(self, src: Path) -> Optional[_AudioCopy]:
        """Re-encode the source audio (reference `-c:a aac` default path,
        ffmpeg.py:400-408); returns None to signal fallback to copy."""
        from .audio import free_audio_ctx, transcode_audio_packets

        result = transcode_audio_packets(
            src, self._audio_mode, bitrate_to_bits(self._audio_bitrate),
            sample_rate=self._audio_sample_rate,
            channels=self._audio_channels,
        )
        if result is None:
            return None
        enc_ctx, packets, (tb_num, tb_den) = result
        try:
            ffi = self.ffi
            out_st = ffi.avformat.avformat_new_stream(self._ofmt, None)
            if not out_st:
                return None
            opar = _r_ptr(out_st, OFF["st_codecpar"])
            if ffi.avcodec.avcodec_parameters_from_context(
                c_void_p(opar), c_void_p(enc_ctx)
            ) < 0:
                return None
            otb = _r_rational(out_st, OFF["st_time_base"])
            otb.num, otb.den = tb_num, tb_den
            return _AudioCopy(
                packets=packets,
                src_time_base=(tb_num, tb_den),
                out_stream_index=_r_i32(out_st, OFF["st_index"]),
                out_st=out_st,
            )
        finally:
            free_audio_ctx(enc_ctx)

    def _write_audio_packets(self):
        if not self._audio or not self._audio.packets:
            return
        ffi = self.ffi
        ffi.avcodec.av_new_packet.argtypes = [c_void_p, __import__("ctypes").c_int]
        ffi.avcodec.av_new_packet.restype = __import__("ctypes").c_int
        src_tb = Rational(*self._audio.src_time_base)
        dst_tb = _r_rational(self._audio.out_st, OFF["st_time_base"])
        for data, pts, dts, duration, flags in self._audio.packets:
            pkt = self._pkt
            ffi.check(ffi.avcodec.av_new_packet(c_void_p(pkt), len(data)), "new_packet")
            memmove(_r_ptr(pkt, OFF["pkt_data"]), data, len(data))
            _w_i64(pkt, OFF["pkt_pts"], pts)
            _w_i64(pkt, OFF["pkt_dts"], dts)
            _w_i64(pkt, OFF["pkt_duration"], duration)
            _w_i32(pkt, OFF["pkt_flags"], flags)
            _w_i32(pkt, OFF["pkt_stream_index"], self._audio.out_stream_index)
            ffi.avcodec.av_packet_rescale_ts(c_void_p(pkt), src_tb, dst_tb)
            ffi.check(
                ffi.avformat.av_interleaved_write_frame(self._ofmt, c_void_p(pkt)),
                "write audio packet",
            )

    # -- video --------------------------------------------------------------
    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
              pts: Optional[int] = None) -> None:
        ffi = self.ffi
        s = self.settings
        ffi.check(
            ffi.avutil.av_frame_make_writable(c_void_p(self._frm)), "frame_make_writable"
        )
        planes = [
            (np.ascontiguousarray(y), (s.height, s.width)),
            (np.ascontiguousarray(u), self._chroma_size),
            (np.ascontiguousarray(v), self._chroma_size),
        ]
        for i, (arr, (ph, pw)) in enumerate(planes):
            if arr.shape != (ph, pw):
                raise ValueError(f"plane {i} shape {arr.shape}, want {(ph, pw)}")
            want_dt = np.uint8 if self._itemsize == 1 else np.uint16
            if arr.dtype != want_dt:
                arr = arr.astype(want_dt)
            data = _r_ptr(self._frm, OFF["frame_data"] + 8 * i)
            ls = _r_i32(self._frm, OFF["frame_linesize"] + 4 * i)
            row = pw * self._itemsize
            if ls == row:
                memmove(data, arr.ctypes.data, row * ph)
            else:
                for r in range(ph):
                    memmove(data + r * ls, arr.ctypes.data + r * row, row)
        _w_i64(self._frm, OFF["frame_pts"], pts if pts is not None else self._findex)
        self._findex += 1
        ffi.check(
            ffi.avcodec.avcodec_send_frame(c_void_p(self._ctx), c_void_p(self._frm)),
            "send_frame",
        )
        self._drain(False)

    def _drain(self, flush: bool):
        ffi = self.ffi
        while True:
            r = ffi.avcodec.avcodec_receive_packet(c_void_p(self._ctx), c_void_p(self._pkt))
            if r in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            ffi.check(r, "receive_packet")
            # one frame per packet in enc time base (1/fps); without an
            # explicit duration the muxer drops the last frame's span and the
            # probed average fps drifts (50 frames / 1.96 s = 25.51).
            if _r_i64(self._pkt, OFF["pkt_duration"]) == 0:
                _w_i64(self._pkt, OFF["pkt_duration"], 1)
            ffi.avcodec.av_packet_rescale_ts(
                c_void_p(self._pkt), self._enc_tb, self._st_tb
            )
            _w_i32(self._pkt, OFF["pkt_stream_index"], _r_i32(self._st, OFF["st_index"]))
            ffi.check(
                ffi.avformat.av_interleaved_write_frame(self._ofmt, c_void_p(self._pkt)),
                "write_frame",
            )

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        ffi = self.ffi
        try:
            ffi.check(
                ffi.avcodec.avcodec_send_frame(c_void_p(self._ctx), None), "flush"
            )
            self._drain(True)
            self._write_audio_packets()
            ffi.check(ffi.avformat.av_write_trailer(self._ofmt), "write_trailer")
        finally:
            self._abort()

    def _abort(self):
        ffi = self.ffi
        if getattr(self, "_pkt", None):
            p = c_void_p(self._pkt)
            ffi.avcodec.av_packet_free(byref(p))
            self._pkt = None
        if getattr(self, "_frm", None):
            p = c_void_p(self._frm)
            ffi.avutil.av_frame_free(byref(p))
            self._frm = None
        if getattr(self, "_ctx", None):
            p = c_void_p(self._ctx)
            ffi.avcodec.avcodec_free_context(byref(p))
            self._ctx = None
        if self._ofmt and self._ofmt.value:
            pb = c_void_p(_r_ptr(self._ofmt.value, OFF["fmt_pb"]))
            if pb.value:
                ffi.avformat.avio_closep(byref(pb))
                memmove(self._ofmt.value + OFF["fmt_pb"], byref(c_void_p(0)), 8)
            ffi.avformat.avformat_free_context(self._ofmt)
            self._ofmt = c_void_p(0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._abort()
