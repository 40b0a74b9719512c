"""Stage executor: the pipelined decode -> device render -> encode hot loop.

Reference analog: one FFmpeg subprocess per stage with its stderr parsed for
progress (src/lut_renderer/task_manager.py:134-190). Here the loop is
first-party and pipelined:

    [decode thread] --batchQ--> [main: jitted device render] --encQ--> [encode thread]

Bounded queues give double buffering: while the device renders batch N, the
decode thread fills N+1 and the encode thread drains N-1. Batches are padded
to a fixed shape so XLA compiles exactly once per stage. Frame-accurate
progress (0..100) and per-phase throughput stats replace stderr scraping.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..hostio.decode import VideoDecoder
from ..hostio.encode import VideoEncoder
from ..models import VideoInfo
from ..ops.prepare import PreparedLut
from ..ops.render import make_render_fn
from ..plan.policy import RenderSpec
from .config import (
    derive_encoder_settings,
    derive_render_config,
    effective_output_pix_fmt,
    output_fps,
    parse_resolution,
)
from .scheduler import FrameScheduler

ProgressCb = Callable[[int], None]
LogCb = Callable[[str], None]


@dataclass
class StageStats:
    frames_in: int = 0
    frames_out: int = 0
    wall_s: float = 0.0
    decode_s: float = 0.0
    render_s: float = 0.0
    encode_s: float = 0.0
    batches: int = 0

    def summary(self) -> str:
        def rate(n, t):
            return f"{n / t:.1f} fps" if t > 0 else "n/a"

        return (
            f"{self.frames_out} frames in {self.wall_s:.2f}s "
            f"({rate(self.frames_out, self.wall_s)} overall; "
            f"decode {rate(self.frames_in, self.decode_s)}, "
            f"render {rate(self.frames_out, self.render_s)}, "
            f"encode {rate(self.frames_out, self.encode_s)})"
        )


@dataclass
class StageResult:
    ok: bool
    canceled: bool = False
    error: str = ""
    stats: StageStats = field(default_factory=StageStats)


def _pick_batch_size(width: int, height: int) -> int:
    # target ~16 Mpix per device step; clamp to [1, 16]
    per = max(1, width * height)
    return int(max(1, min(16, round(16_000_000 / per))))


def run_stage(
    spec: RenderSpec,
    source_info: Optional[VideoInfo],
    prep: Optional[PreparedLut],
    progress_cb: Optional[ProgressCb] = None,
    log_cb: Optional[LogCb] = None,
    cancel: Optional[threading.Event] = None,
    batch_size: Optional[int] = None,
    profile_dir: Optional[str] = None,
    use_mesh: Optional[bool] = None,
    decoder=None,
    encoder_factory: Callable[..., VideoEncoder] = VideoEncoder,
) -> StageResult:
    """Render one stage: decode spec.source, render it on the device, and
    encode spec.output.

    decoder: an already-open frame source (width, height, iteration over
    frames with y/u/v planes, close()); None opens VideoDecoder(spec.source).
    encoder_factory: called like VideoEncoder(output, settings, **audio
    options) to open the sink. Both let a caller drive the executor without
    media files."""
    log = log_cb or (lambda m: None)
    progress = progress_cb or (lambda p: None)
    cancel = cancel or threading.Event()
    stats = StageStats()
    t_start = time.perf_counter()

    try:
        dec = decoder if decoder is not None else VideoDecoder(spec.source)
    except Exception as exc:
        return StageResult(ok=False, error=f"decode open failed: {exc}")

    try:
        w, h = dec.width, dec.height
        if w % 2 or h % 2:
            return StageResult(
                ok=False,
                error=f"odd frame dimensions {w}x{h} unsupported for 4:2:0",
            )
        import dataclasses as _dc

        eff_pix = effective_output_pix_fmt(spec, source_info)
        if eff_pix != spec.pix_fmt:
            spec = _dc.replace(spec, pix_fmt=eff_pix)
            log(f"engine: output pix_fmt negotiated to {eff_pix} "
                f"({spec.video_codec} supported formats)")
        cfg = derive_render_config(spec, source_info)
        out_w, out_h = parse_resolution(spec.resolution) or (w, h)
        enc_settings = derive_encoder_settings(spec, source_info, out_w, out_h)
        fps = output_fps(spec, source_info)
        if cfg.resize == (w, h):
            # taskfactory's smart defaults echo the source size into
            # `resolution` (the reference main-window behavior), so EVERY
            # queued job used to carry an identity resize — which forced
            # the plain layout + two identity matmuls per plane AND an
            # exact-shape program class (blocking geometry bucketing, so
            # ad hoc daemon jobs recompiled instead of riding the warmed
            # ladder — found via a wedged soak, round 5). The 1:1 resample
            # is verified BIT-EXACT end to end (resample(x) == x; the
            # weight matrices carry ~3e-16 off-diagonal residue but it is
            # below the f32 output ulp), so dropping the no-op is safe.
            cfg = _dc.replace(cfg, resize=None)
        # With LUT_TPU_GEOMETRY=bucket, ad hoc geometries ride a
        # bucket-shaped precompiled program via host-side pad-and-crop
        # (engine.geometry). Resize keeps exact shapes (its output depends
        # on input geometry globally).
        from .geometry import (
            crop_batch_from_bucket,
            pad_batch_to_bucket,
            pick_bucket,
        )

        bucket = pick_bucket(w, h) if cfg.resize is None else None
        bsz = batch_size or _pick_batch_size(*(bucket or (w, h)))
        log(
            f"engine: {w}x{h} -> {out_w}x{out_h} @{float(fps):.3f}fps, "
            f"batch={bsz}, in {cfg.in_depth}bit/{cfg.in_subsampling} "
            f"-> out {cfg.out_depth}bit/{cfg.out_subsampling}, "
            f"interp={cfg.interp}, dither={cfg.dither}, "
            f"matrix {cfg.matrix_in}->{cfg.matrix_out}"
        )
        if bucket is not None:
            log(f"engine: geometry rides the {bucket[0]}x{bucket[1]} bucket "
                f"program (host pad-and-crop; ad hoc shapes reuse the "
                f"warmed ladder instead of compiling)")

        audio_from = (
            Path(spec.source)
            if (source_info and source_info.audio_codec and spec.audio_codec)
            else None
        )
        audio_mode = spec.audio_codec or "copy"

        def _as_int(v):
            try:
                return int(float(v)) if v else None
            except (TypeError, ValueError):
                return None

        try:
            enc = encoder_factory(spec.output, enc_settings,
                                  audio_from=audio_from,
                                  audio_mode=audio_mode,
                                  audio_bitrate=spec.audio_bitrate,
                                  audio_sample_rate=_as_int(spec.sample_rate),
                                  audio_channels=_as_int(spec.channels))
        except Exception as exc:
            dec.close()
            return StageResult(ok=False, error=f"encoder open failed: {exc}")

        # Multi-chip: shard the frame batch over all visible devices
        # (BASELINE config 5's frame-sharded pipeline). Auto-on when more
        # than one device exists; batch rounds up to a mesh multiple.
        import jax as _jax

        devices = _jax.devices()
        mesh = None
        put_fn = None
        if use_mesh is None:
            use_mesh = len(devices) > 1
        if use_mesh and len(devices) > 1:
            from ..parallel import default_mesh, make_sharded_render_fn
            from ..parallel.sharding import put_sharded

            mesh = default_mesh(devices)
            ndev = len(devices)
            bsz = max(ndev, ((bsz + ndev - 1) // ndev) * ndev)
            render_fn = make_sharded_render_fn(prep, cfg, mesh)
            put_fn = lambda *arrs: put_sharded(mesh, *arrs)  # noqa: E731
            log(f"engine: frame batch sharded over {ndev} devices "
                f"({devices[0].platform}), batch={bsz}")
        else:
            render_fn = make_render_fn(prep, cfg)
        sched = FrameScheduler(spec.fps_mode, fps)

        total_est = None
        if source_info:
            if spec.fps_mode == "cfr" and source_info.duration:
                total_est = int(source_info.duration * float(fps))
            elif source_info.nb_frames:
                total_est = source_info.nb_frames
            elif source_info.duration and source_info.fps:
                total_est = int(source_info.duration * source_info.fps)

        batch_q: "queue.Queue" = queue.Queue(maxsize=2)
        enc_q: "queue.Queue" = queue.Queue(maxsize=2)
        enc_error: list = []

        def _stage_batch(ys, us, vs):
            # geometry pad runs HERE on the decode thread, overlapping the
            # device's render of the previous batch (in the main loop it
            # serialized with dispatch — ~0.5 s/4K batch of host fill)
            a, b, c = np.stack(ys), np.stack(us), np.stack(vs)
            if bucket is not None:
                a, b, c = pad_batch_to_bucket(a, b, c, bucket,
                                              cfg.in_subsampling)
            return a, b, c

        def decode_loop():
            t0 = time.perf_counter()
            ys, us, vs = [], [], []
            try:
                for frame in sched.schedule(iter(dec)):
                    if cancel.is_set():
                        break
                    stats.frames_in += 1
                    ys.append(frame.y)
                    us.append(frame.u)
                    vs.append(frame.v)
                    if len(ys) == bsz:
                        batch_q.put(("batch", *_stage_batch(ys, us, vs), bsz))
                        ys, us, vs = [], [], []
                if ys and not cancel.is_set():
                    count = len(ys)
                    while len(ys) < bsz:  # pad to the compiled shape
                        ys.append(ys[-1]); us.append(us[-1]); vs.append(vs[-1])
                    batch_q.put(("batch", *_stage_batch(ys, us, vs), count))
                batch_q.put(("eof", None, None, None, 0))
            except Exception as exc:  # pragma: no cover - propagated below
                batch_q.put(("error", exc, None, None, 0))
            finally:
                stats.decode_s += time.perf_counter() - t0

        host_ed = cfg.dither == "error_diffusion_host"
        if host_ed:
            from ..native_ext import error_diffusion_quantize

            def _finish(plane):
                out = error_diffusion_quantize(plane, cfg.out_depth)
                if out is None:  # native lib vanished mid-run: plain rounding
                    maxv = (1 << cfg.out_depth) - 1
                    out = np.clip(np.floor(plane + 0.5), 0, maxv).astype(
                        np.uint8 if cfg.out_depth <= 8 else np.uint16
                    )
                return out

        def encode_loop():
            while True:
                item = enc_q.get()
                if item is None:
                    return
                yq, uq, vq, count = item
                t0 = time.perf_counter()
                try:
                    for i in range(count):
                        if host_ed:
                            enc.write(_finish(yq[i]), _finish(uq[i]), _finish(vq[i]))
                            stats.frames_out += 1
                            if total_est:
                                progress(min(99, int(100 * stats.frames_out / total_est)))
                            continue
                        enc.write(yq[i], uq[i], vq[i])
                        stats.frames_out += 1
                        if total_est:
                            progress(min(99, int(100 * stats.frames_out / total_est)))
                except Exception as exc:
                    enc_error.append(exc)
                    return
                finally:
                    stats.encode_s += time.perf_counter() - t0

        dec_thread = threading.Thread(target=decode_loop, daemon=True)
        enc_thread = threading.Thread(target=encode_loop, daemon=True)
        dec_thread.start()
        enc_thread.start()

        profiling = False
        if profile_dir:
            # device-level trace of the render loop (SURVEY.md §5.1: the
            # rebuild's tracing replaces the reference's stderr scraping)
            try:
                import jax

                jax.profiler.start_trace(profile_dir)
                profiling = True
                log(f"engine: jax profiler trace -> {profile_dir}")
            except Exception as exc:
                log(f"engine: profiler unavailable ({exc})")

        error: Optional[str] = None

        def emit(item) -> Optional[str]:
            # bounded put that won't deadlock if the encoder died
            while True:
                if enc_error:
                    return f"encode failed: {enc_error[0]}"
                try:
                    enc_q.put(item, timeout=1.0)
                    return None
                except queue.Full:
                    continue

        try:
            # One batch kept in flight: batch N+1 is dispatched to the device
            # BEFORE blocking on batch N's D2H readback, so device compute
            # overlaps the transfer instead of serializing with it.
            in_flight = None  # (device arrays y/u/v, count)
            while True:
                if cancel.is_set():
                    break
                kind, a, b, c, count = batch_q.get()
                if kind == "error":
                    error = f"decode failed: {a}"
                    break
                t0 = time.perf_counter()
                dispatched = None
                if kind != "eof":
                    if put_fn is not None:
                        a, b, c = put_fn(a, b, c)
                    dispatched = (*render_fn(a, b, c), count)
                if in_flight is not None:
                    yq, uq, vq, n_prev = in_flight
                    # device -> host (blocks until that batch is computed)
                    yq = np.asarray(yq)
                    uq = np.asarray(uq)
                    vq = np.asarray(vq)
                    if bucket is not None:
                        yq, uq, vq = crop_batch_from_bucket(
                            yq, uq, vq, out_w, out_h, cfg.out_subsampling)
                    stats.render_s += time.perf_counter() - t0
                    stats.batches += 1
                    error = emit((yq, uq, vq, n_prev))
                else:
                    stats.render_s += time.perf_counter() - t0
                in_flight = dispatched
                if error or kind == "eof":
                    break
            if in_flight is not None and not error and not cancel.is_set():
                t0 = time.perf_counter()
                yq, uq, vq, n_prev = in_flight
                yq = np.asarray(yq)
                uq = np.asarray(uq)
                vq = np.asarray(vq)
                if bucket is not None:
                    yq, uq, vq = crop_batch_from_bucket(
                        yq, uq, vq, out_w, out_h, cfg.out_subsampling)
                stats.render_s += time.perf_counter() - t0
                stats.batches += 1
                error = emit((yq, uq, vq, n_prev))
        finally:
            if profiling:
                try:
                    import jax

                    jax.profiler.stop_trace()
                except Exception:
                    pass
            cancel_set = cancel.is_set()
            if cancel_set or error:
                cancel.set()
            # unblock and retire the decode thread (it may be blocked on put)
            while dec_thread.is_alive():
                try:
                    while True:
                        batch_q.get_nowait()
                except queue.Empty:
                    pass
                dec_thread.join(timeout=0.5)
            # retire the encode thread; only drop queued batches on failure
            while True:
                try:
                    enc_q.put(None, timeout=1.0)
                    break
                except queue.Full:
                    if not enc_thread.is_alive():
                        break
                    if cancel_set or error:
                        try:
                            enc_q.get_nowait()
                        except queue.Empty:
                            pass
            enc_thread.join(timeout=60)
            dec.close()

        if enc_error and not error:
            error = f"encode failed: {enc_error[0]}"
        if error or cancel_set:
            try:
                enc._abort()
            except Exception:
                pass
            stats.wall_s = time.perf_counter() - t_start
            if cancel_set and not error:
                return StageResult(ok=False, canceled=True, stats=stats)
            return StageResult(ok=False, error=error or "canceled", stats=stats)

        try:
            enc.close()
        except Exception as exc:
            stats.wall_s = time.perf_counter() - t_start
            return StageResult(ok=False, error=f"finalize failed: {exc}", stats=stats)

        stats.wall_s = time.perf_counter() - t_start
        progress(100)
        # stats reach logs via the caller (tasks.runner logs summary() on
        # every outcome, not just success — SURVEY §5.1 observability)
        return StageResult(ok=True, stats=stats)
    except Exception as exc:
        stats.wall_s = time.perf_counter() - t_start
        try:
            dec.close()
        except Exception:
            pass
        return StageResult(ok=False, error=str(exc), stats=stats)
