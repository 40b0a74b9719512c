#!/usr/bin/env python3
"""Smoke test of the render path on an NVIDIA GPU, at real frame sizes.

Run from the repository root on a machine with the card:

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --multi   # config 5 frame-sharded over four cards

One process drives the card. Phases (one card):

  1. device     JAX version, devices, the card's name and power limit, the
                compile-cache directory;
  2. LUT core   ops.lut3d.apply_lut_planes on a 3840x2160 float RGB frame,
                every interp at 33^3, tetrahedral at 65^3 and 129^3, and a
                non-unit domain, against the NumPy interpolators
                (max abs <= 1e-5, max dE76 <= 1e-3);
  3. render     the jitted render step for the BASELINE configs and a 4K ->
                1080p resize, each against the NumPy pipeline reference
                (colorcore.pipeline): at most 1 code value off, on fewer
                than 1e-3 of the samples;
  4. executor   engine.executor.run_stage over several batches of 4K 10-bit
                4:2:2 frames from an in-memory source, whose output must
                equal phase 3's step output;
  5. media      where the FFmpeg libraries load: `render` through the CLI on
                a generated clip and on one with audio (AAC re-encode, or
                the noted stream copy where libavfilter is missing), and a
                QueueServer answering two submits;
  6. card tests `pytest -m gpu`, in this process.

--multi runs only config 5: run_stage and make_sharded_render_fn on 8K
10-bit 4:2:2 frames over a 4-device mesh, against the same frames on one
device at the 1-code-value bound.

A failing phase raises, so the script exits non-zero and prints no result.
The last line of a passing run is one JSON object naming the device.
Without a GPU the script exits non-zero before any work.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
MAX_ABS = 1e-5        # phase 2: float32 LUT core vs NumPy
MAX_DE76 = 1e-3
LSB_FRACTION = 1e-3   # phases 3 and --multi: share of samples 1 code off


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found "
            f"{devices[0].platform} ({devices[0].device_kind})")
    return devices


# ---- inputs ----------------------------------------------------------------

def rgb_frame(rng, h: int, w: int) -> np.ndarray:
    """Random float RGB with rows of exact 0, exact 1 and lattice points."""
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    rgb[0] = 0.0
    rgb[1] = 1.0
    rgb[2] = rng.integers(0, 33, (w, 3)) / np.float32(32)
    return rgb


def check_lsb(label: str, got, want) -> None:
    for name, a, e in zip("yuv", got, want):
        a = np.asarray(a)
        if a.shape != e.shape or a.dtype != e.dtype:
            raise AssertionError(f"{label} plane {name}: {a.shape}/{a.dtype} "
                                 f"vs reference {e.shape}/{e.dtype}")
        d = np.abs(a.astype(np.int64) - e.astype(np.int64))
        frac = float(np.mean(d > 0))
        log(f"    plane {name} {a.shape}: max |d| = {int(d.max())} code, "
            f"share off = {frac:.3e}")
        if d.max() > 1 or frac >= LSB_FRACTION:
            raise AssertionError(f"{label} plane {name}: max |d| {d.max()}, "
                                 f"share {frac} (bound: 1 code on < "
                                 f"{LSB_FRACTION})")


def pro_master_stage(width: int, height: int):
    """The spec, source info and render config of a 10-bit 4:2:2 ProRes
    pro-master stage (BASELINE config 3 stage 1, and config 5's format),
    derived through the policy layer as the executor derives them."""
    from lut_renderer_tpu.engine.config import derive_render_config
    from lut_renderer_tpu.models import ProcessingParams, VideoInfo
    from lut_renderer_tpu.plan import build_render_spec

    info = VideoInfo(width=width, height=height, fps=25.0,
                     pix_fmt="yuv422p10le", bit_depth=10,
                     codec_name="prores")
    spec = build_render_spec(Path("smoke_in.mov"), Path("smoke_out.mov"),
                             ProcessingParams(video_codec="prores_ks"),
                             Path("smoke.cube"), info)
    return spec, info, derive_render_config(spec, info)


class MemoryDecoder:
    """In-memory stand-in for hostio.VideoDecoder (run_stage's decoder)."""

    def __init__(self, y, u, v, pix_fmt: str, depth: int):
        self.y, self.u, self.v = y, u, v
        self.height, self.width = y.shape[-2:]
        self.pix_fmt, self.depth = pix_fmt, depth

    def __iter__(self):
        from lut_renderer_tpu.hostio.decode import DecodedFrame

        for i in range(self.y.shape[0]):
            yield DecodedFrame(i, None, None, self.y[i], self.u[i], self.v[i],
                               self.pix_fmt, self.depth, False)

    def close(self):
        pass


class MemorySink:
    """In-memory stand-in for hostio.VideoEncoder (run_stage's encoder)."""

    def __init__(self):
        self.frames = []

    def open(self, output, settings, **_audio):
        return self

    def write(self, y, u, v):
        self.frames.append((np.array(y), np.array(u), np.array(v)))

    def close(self):
        pass

    def _abort(self):
        pass


# ---- phases ----------------------------------------------------------------

def phase_device(devices) -> None:
    import jax

    from lut_renderer_tpu.utils.cardrun import card_line
    from lut_renderer_tpu.utils.compile_cache import (
        enable_persistent_compile_cache,
    )

    log("== phase 1: device")
    log(f"jax {jax.__version__}; {len(devices)} device(s): "
        + ", ".join(f"{d} [{d.device_kind}]" for d in devices))
    log("card (nvidia-smi name, power.limit):")
    log(card_line())
    log(f"compile cache: {enable_persistent_compile_cache()}")


def phase_lut_core(h: int = 2160, w: int = 3840) -> None:
    import jax

    from lut_renderer_tpu.colorcore import INTERP_MODES, max_delta_e76
    from lut_renderer_tpu.colorcore.interp import apply_lut
    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.lut3d import apply_lut_planes
    from lut_renderer_tpu.utils.cardrun import noisy_lut

    log(f"== phase 2: LUT core at {w}x{h} vs colorcore.interp (NumPy)")
    rgb = rgb_frame(np.random.default_rng(SEED), h, w)
    planes = [jax.device_put(rgb[..., c]) for c in range(3)]
    cases = [(interp, 33, None) for interp in INTERP_MODES]
    cases += [("tetrahedral", 65, None), ("tetrahedral", 129, None),
              ("tetrahedral", 33, ((0.0, 0.05, 0.1), (0.9, 1.0, 0.8)))]
    for interp, n, domain in cases:
        lut = noisy_lut(n, domain=domain)
        prep = prepare_lut(lut)
        step = jax.jit(lambda r, g, b, t: apply_lut_planes(
            r, g, b, prep, interp, table=t))
        out = step(*planes, jax.device_put(prep.table))
        got = np.stack([np.asarray(o) for o in out], axis=-1)
        want = apply_lut(rgb, lut, interp)
        max_abs = float(np.abs(got - want).max())
        de = float(max_delta_e76(np.clip(got, 0, 1), np.clip(want, 0, 1)))
        tag = f"{interp} {n}^3" + (" non-unit domain" if domain else "")
        log(f"  {tag}: max abs {max_abs:.3e}, max dE76 {de:.3e}")
        if max_abs > MAX_ABS or de > MAX_DE76:
            raise AssertionError(f"LUT core {tag}: max abs {max_abs}, "
                                 f"dE76 {de} (bound {MAX_ABS}, {MAX_DE76})")


def render_configs():
    """(label, width, height, LUT size or None, RenderConfig) for phase 3."""
    from lut_renderer_tpu.ops import RenderConfig

    _, _, master = pro_master_stage(3840, 2160)
    _, _, master8k = pro_master_stage(7680, 4320)
    return [
        ("config 1: 1080p 8-bit 4:2:0 trilinear 33^3", 1920, 1080, 33,
         RenderConfig(interp="trilinear")),
        ("config 2: 1080p 10-bit -> 8-bit 4:2:0 ordered dither 65^3",
         1920, 1080, 65, RenderConfig(in_depth=10, dither="ordered")),
        ("config 3 stage 1: 4K 10-bit 4:2:2 pro master 33^3",
         3840, 2160, 33, master),
        ("config 3 stage 2: 4K 10-bit 4:2:2 -> 8-bit 4:2:0 dither, no LUT",
         3840, 2160, None,
         RenderConfig(in_depth=10, in_subsampling="422", dither="ordered",
                      apply_lut=False)),
        ("config 4: 1080p full-range -> tv 33^3", 1920, 1080, 33,
         RenderConfig(in_full_range=True)),
        ("config 5 per card: 8K 10-bit 4:2:2 33^3", 7680, 4320, 33,
         master8k),
        ("resize: 4K 8-bit 4:2:0 -> 1920x1080 33^3", 3840, 2160, 33,
         RenderConfig(resize=(1920, 1080))),
    ]


def render_step(prep, cfg):
    """The jitted step make_render_fn builds, as a function of explicit
    (y, u, v, table, resize weights) arguments so it can be lowered."""
    import jax

    from lut_renderer_tpu.ops.render import render_yuv_frame

    return jax.jit(lambda y, u, v, t, rsw: render_yuv_frame(
        y, u, v, prep, cfg, lut_table=t, resize_weights=rsw))


def phase_render(configs, scale: int = 1) -> dict:
    """Returns {label: (compiled step, table, batch size)} for phase 4."""
    import jax

    from lut_renderer_tpu.colorcore.pipeline import render_yuv_reference
    from lut_renderer_tpu.engine.executor import _pick_batch_size
    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.resample import resample_weights
    from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch

    log("== phase 3: render step vs colorcore.pipeline (NumPy)")
    rng = np.random.default_rng(SEED + 1)
    steps = {}
    for label, w, h, n, cfg in configs:
        w, h = w // scale, h // scale
        if cfg.resize is not None:
            cfg = dataclasses.replace(cfg, resize=(cfg.resize[0] // scale,
                                                   cfg.resize[1] // scale))
        batch = _pick_batch_size(w, h)
        log(f"  {label}: {w}x{h} batch {batch}")
        y, u, v = yuv_batch(rng, batch, h, w, cfg)
        lut = noisy_lut(n) if n else None
        prep = prepare_lut(lut) if lut else None
        table = jax.device_put(prep.table) if prep else None
        rsw_np = (resample_weights((h, w), (cfg.resize[1], cfg.resize[0]))
                  if cfg.resize else None)
        rsw = jax.device_put(rsw_np) if rsw_np is not None else None
        dev = [jax.device_put(a) for a in (y, u, v)]
        t0 = time.perf_counter()
        compiled = render_step(prep, cfg).lower(*dev, table, rsw).compile()
        log(f"    compile {time.perf_counter() - t0:.2f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        got = [np.asarray(o) for o in compiled(*dev, table, rsw)]
        want = render_yuv_reference(y, u, v, cfg, prep, rsw_np)
        check_lsb(label, got, want)
        steps[label] = (compiled, table, batch)
    return steps


def phase_executor(compiled, table, batch: int, w: int = 3840,
                   h: int = 2160, n_batches: int = 3) -> None:
    import jax

    from lut_renderer_tpu.engine.executor import run_stage
    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch

    log(f"== phase 4: engine.executor.run_stage, {n_batches} batches of "
        f"{batch} {w}x{h} 10-bit 4:2:2 frames")
    spec, info, cfg = pro_master_stage(w, h)
    prep = prepare_lut(noisy_lut(33))
    y, u, v = yuv_batch(np.random.default_rng(SEED + 2),
                        n_batches * batch, h, w, cfg)
    sink = MemorySink()
    res = run_stage(spec, info, prep, log_cb=lambda m: log(f"    {m}"),
                    batch_size=batch,
                    decoder=MemoryDecoder(y, u, v, info.pix_fmt, 10),
                    encoder_factory=sink.open)
    if not res.ok:
        raise AssertionError(f"run_stage failed: {res.error}")
    if len(sink.frames) != y.shape[0]:
        raise AssertionError(f"run_stage wrote {len(sink.frames)} frames, "
                             f"want {y.shape[0]}")
    for b in range(n_batches):
        sl = slice(b * batch, (b + 1) * batch)
        want = [np.asarray(o) for o in compiled(
            *(jax.device_put(a[sl]) for a in (y, u, v)), table, None)]
        for i in range(batch):
            for name, a, e in zip("yuv", sink.frames[b * batch + i],
                                  (p[i] for p in want)):
                if not np.array_equal(a, e):
                    raise AssertionError(
                        f"run_stage frame {b * batch + i} plane {name} "
                        f"differs from the phase-3 step output")
    log(f"  {len(sink.frames)} frames equal the phase-3 step output")
    log(f"  smoke timing, not a benchmark: {res.stats.summary()}")


def phase_media(tmp: Path, w: int = 1920, h: int = 1080,
                frames: int = 24) -> bool:
    from lut_renderer_tpu.hostio.ffi import FFIUnavailable, get_ffi

    log("== phase 5: media path")
    try:
        get_ffi()
    except FFIUnavailable as exc:
        log(f"  media path not run: the FFmpeg libraries do not load "
            f"here ({exc})")
        return False

    from lut_renderer_tpu.app.cli import main as cli_main
    from lut_renderer_tpu.app.server import QueueServer, request
    from lut_renderer_tpu.colorcore import write_cube_file
    from lut_renderer_tpu.hostio import probe_video
    from lut_renderer_tpu.hostio.encode import audio_reencode_available
    from lut_renderer_tpu.utils.cardrun import noisy_lut
    from lut_renderer_tpu.utils.fixtures import make_av_clip, make_gradient_clip

    clip = make_gradient_clip(tmp / "clip.mp4", w, h, fps=25.0, frames=frames)
    av_clip = make_av_clip(tmp / "av.mov", w, h, frames=frames,
                           audio_seconds=frames / 25.0)
    cube = write_cube_file(tmp / "look.cube", noisy_lut(33))

    def cli_render(src, out_dir, *extra):
        rc = cli_main(["render", str(src), "--lut", str(cube), "--codec",
                       "mpeg4", "--out-dir", str(out_dir), *extra])
        outs = list(out_dir.glob("*"))
        if rc != 0 or len(outs) != 1:
            raise AssertionError(f"cli render {src.name} rc={rc}, "
                                 f"outputs {outs}")
        info = probe_video(outs[0])
        log(f"  cli render {src.name} -> {outs[0].name}: {info.width}x"
            f"{info.height} {info.pix_fmt} {info.nb_frames} frames, audio "
            f"{info.audio_codec}")
        if (info.width, info.height) != (w, h):
            raise AssertionError(f"cli render output {info.width}x"
                                 f"{info.height}")
        return info

    cli_render(clip, tmp / "cli")
    # An AAC re-encode of the audio. Without libavfilter the stream is
    # copied instead, and the preflight must say so.
    reencode = audio_reencode_available()
    plan = io.StringIO()
    with contextlib.redirect_stdout(plan):
        rc = cli_main(["render", str(av_clip), "--lut", str(cube), "--codec",
                       "mpeg4", "--audio-codec", "aac", "--dry-run"])
    noted = "needs libavfilter" in plan.getvalue()
    log(f"  libavfilter {'loaded' if reencode else 'missing'}; "
        f"dry-run notes the audio copy: {noted}")
    if rc != 0 or noted == reencode:
        raise AssertionError(f"dry-run rc={rc}; libavfilter loaded "
                             f"{reencode} but copy note {noted}:\n"
                             f"{plan.getvalue()}")
    info = cli_render(av_clip, tmp / "cli_av", "--audio-codec", "aac")
    want_audio = "aac" if reencode else probe_video(av_clip).audio_codec
    if info.audio_codec != want_audio:
        raise AssertionError(f"cli render audio {info.audio_codec}, want "
                             f"{want_audio}")

    server = QueueServer(tmp / "smoke.sock")
    server.start()
    try:
        ids = []
        for k in range(2):
            resp = request(server.socket_path, {
                "op": "submit", "files": [str(clip)], "lut": str(cube),
                "params": {"video_codec": "mpeg4"},
                "out_dir": str(tmp / f"served{k}")})
            if not resp.get("ok"):
                raise AssertionError(f"submit {k}: {resp}")
            ids += resp["task_ids"]
        deadline = time.time() + 300
        while True:
            tasks = {t["task_id"]: t for t in
                     request(server.socket_path, {"op": "status"})["tasks"]}
            states = [tasks[i]["status"] for i in ids]
            if all(s in ("completed", "failed", "canceled") for s in states):
                break
            if time.time() > deadline:
                raise AssertionError(f"served jobs did not finish: {states}")
            time.sleep(0.2)
        if states != ["completed", "completed"]:
            raise AssertionError(
                f"served jobs: {[(tasks[i]['status'], tasks[i]['error']) for i in ids]}")
        log(f"  QueueServer answered 2 submits: {states}")
    finally:
        server.stop()
    return True


def phase_card_tests() -> None:
    import pytest

    log("== phase 6: pytest -m gpu (in this process)")
    os.environ["LUT_TPU_TEST_GPU"] = "1"
    rc = pytest.main([str(ROOT / "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {rc}")


def phase_multi(n_devices: int = 4, w: int = 7680, h: int = 4320,
                n_batches: int = 2) -> None:
    import jax

    from lut_renderer_tpu.engine.executor import run_stage
    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.render import make_render_fn
    from lut_renderer_tpu.parallel import default_mesh, make_sharded_render_fn
    from lut_renderer_tpu.parallel.sharding import put_sharded
    from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch

    devices = jax.devices()
    if len(devices) != n_devices:
        raise AssertionError(f"--multi needs {n_devices} devices, JAX sees "
                             f"{len(devices)}")
    log(f"== config 5: {w}x{h} 10-bit 4:2:2 frame-sharded over "
        f"{n_devices} devices vs one device")
    spec, info, cfg = pro_master_stage(w, h)
    prep = prepare_lut(noisy_lut(33))
    total = n_batches * n_devices
    y, u, v = yuv_batch(np.random.default_rng(SEED + 3), total, h, w, cfg)

    single = make_render_fn(prep, cfg)
    ref = [[], [], []]
    for b in range(n_batches):
        sl = slice(b * n_devices, (b + 1) * n_devices)
        for k, o in enumerate(single(*(jax.device_put(a[sl], devices[0])
                                       for a in (y, u, v)))):
            ref[k].append(np.asarray(o))
    ref = [np.concatenate(p) for p in ref]

    mesh = default_mesh(devices)
    sharded = make_sharded_render_fn(prep, cfg, mesh)
    out = sharded(*put_sharded(mesh, y[:n_devices], u[:n_devices],
                               v[:n_devices]))
    if len(out[0].sharding.device_set) != n_devices:
        raise AssertionError("sharded output is not spread over the mesh")
    log("  make_sharded_render_fn vs one device:")
    check_lsb("sharded step", [np.asarray(o) for o in out],
              [p[:n_devices] for p in ref])

    sink = MemorySink()
    res = run_stage(spec, info, prep, log_cb=lambda m: log(f"    {m}"),
                    batch_size=n_devices,
                    decoder=MemoryDecoder(y, u, v, info.pix_fmt, 10),
                    encoder_factory=sink.open)
    if not res.ok or len(sink.frames) != total:
        raise AssertionError(f"run_stage over the mesh: ok={res.ok} "
                             f"{res.error!r}, {len(sink.frames)} frames")
    log("  run_stage over the mesh vs one device:")
    check_lsb("run_stage", [np.stack([f[k] for f in sink.frames])
                            for k in range(3)], ref)
    log(f"  smoke timing, not a benchmark: {res.stats.summary()}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only config 5, frame-sharded over four "
                             "devices, against one device")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    devices = require_gpu()
    sys.path.insert(0, str(ROOT))

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    timed(phase_device, devices)
    if args.multi:
        timed(phase_multi)
    else:
        timed(phase_lut_core)
        configs = render_configs()
        steps = timed(phase_render, configs)
        timed(phase_executor, *steps[configs[2][0]])
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            timed(phase_media, Path(tmp))
        timed(phase_card_tests)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    import jax

    dev = jax.devices()[0]
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
