"""Benchmark: 4K tetrahedral 33^3 LUT application on the accelerator vs
FFmpeg-CPU, plus the BASELINE config classes as render-step rates.

Prints ONE JSON line:
  {"metric": ..., "value": <4K fps>, "unit": "fps", "vs_baseline": <x over
   FFmpeg lut3d on this host's CPU>, "device": {...}, ...}

The baseline is measured, not cited (the reference publishes no numbers —
BASELINE.md): FFmpeg's own lut3d C filter from the bundled libavfilter,
tetrahedral 33^3 on 4K rgb48 frames, on this host (12 frames, median of 3
runs). Where the host's FFmpeg build has no libavfilter the baseline and the
parity probe report their error instead.

Device timing: host clock around a call that ends in block_until_ready, on
inputs already on the device, after a warm-up call that compiles; median of
ITERS calls. Every rate is a device rate, so the script refuses to run
without an accelerator, and a device config that fails makes it exit
non-zero.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

H, W = 2160, 3840
BATCH = 8       # frames per device step
ITERS = 5       # timed calls (median)


def _make_lut():
    import tempfile

    from lut_renderer_tpu.colorcore import write_cube_file
    from lut_renderer_tpu.utils.cardrun import noisy_lut

    lut = noisy_lut(33, seed=11)

    cube = Path(tempfile.mkdtemp(prefix="lutbench_")) / "bench.cube"
    write_cube_file(cube, lut)
    return lut, cube


def card_info() -> str:
    """`nvidia-smi` name and power limit of the card, or the reason there
    is none."""
    from lut_renderer_tpu.utils.cardrun import card_line

    try:
        return card_line()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({exc})"


def _median_seconds(fn, *args) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_lut_fps(lut) -> float:
    """4K frames/s of the LUT core alone (float RGB planes in and out)."""
    import jax

    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.lut3d import apply_lut_planes

    prep = prepare_lut(lut)
    rng = np.random.default_rng(0)
    r, g, b = (jax.device_put(rng.uniform(0, 1, (BATCH, H, W))
                              .astype(np.float32)) for _ in range(3))
    table = jax.device_put(prep.table)
    step = jax.jit(lambda r, g, b, t: apply_lut_planes(
        r, g, b, prep, "tetrahedral", table=t))
    return BATCH / _median_seconds(step, r, g, b, table)


def measure_cpu_fps(cube) -> float:
    from lut_renderer_tpu.hostio.oracle import measure_cpu_lut3d_fps

    runs = [measure_cpu_lut3d_fps(cube, "tetrahedral", W, H, frames=12)
            for _ in range(3)]
    return float(np.median(runs))


def measure_kernel_parity(lut, cube) -> float:
    """Max dE76 of the device LUT path vs FFmpeg's lut3d on a random probe
    frame."""
    import jax.numpy as jnp

    from lut_renderer_tpu.colorcore import max_delta_e76
    from lut_renderer_tpu.hostio.oracle import Lut3DOracle
    from lut_renderer_tpu.ops import prepare_lut
    from lut_renderer_tpu.ops.lut3d import apply_lut_planes

    prep = prepare_lut(lut)
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    with Lut3DOracle(cube, "tetrahedral", "gbrpf32le", 256, 256) as oracle:
        ffm = oracle.apply_rgb_float(rgb)
    ro, go, bo = apply_lut_planes(
        jnp.asarray(rgb[..., 0]), jnp.asarray(rgb[..., 1]),
        jnp.asarray(rgb[..., 2]), prep, "tetrahedral")
    ours = np.stack([np.asarray(ro), np.asarray(go), np.asarray(bo)], -1)
    return float(max_delta_e76(np.clip(ffm, 0, 1), np.clip(ours, 0, 1)))


def _film_lut65():
    """Smooth grading-style 65^3 LUT (the BASELINE config-2 class)."""
    from lut_renderer_tpu.colorcore import Lut3D

    n = 65
    ramp = np.linspace(0, 1, n, dtype=np.float32)
    r, g, b = np.meshgrid(ramp, ramp, ramp, indexing="ij")
    rgb = np.stack([r, g, b], -1)
    luma = 0.2126 * r + 0.7152 * g + 0.0722 * b
    rgb = rgb * rgb * (3 - 2 * rgb) * 0.85 + rgb * 0.15
    l3 = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
          + 0.0722 * rgb[..., 2])[..., None]
    rgb = l3 + (rgb - l3) * 1.15
    rgb[..., 0] += 0.04 * luma * (1 - luma) * 4
    rgb[..., 2] -= 0.02 * luma
    rgb = np.clip(rgb, 0, 1) ** np.array([0.97, 1.0, 1.05], np.float32)
    lut = Lut3D.identity(n)
    lut.table = np.clip(rgb, 0, 1).astype(np.float32)
    return lut


def _resampled(lut, n: int):
    """The same grading content resampled to an n^3 grid (trilinear)."""
    from lut_renderer_tpu.colorcore import Lut3D

    src = lut.size - 1
    idx = np.linspace(0, src, n)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, src)
    f = (idx - lo).astype(np.float32)
    t = lut.table
    for ax in range(3):
        sl_lo, sl_hi = [slice(None)] * 4, [slice(None)] * 4
        sl_lo[ax], sl_hi[ax] = lo, hi
        w = f.reshape([-1 if i == ax else 1 for i in range(3)] + [1])
        t = t[tuple(sl_lo)] * (1 - w) + t[tuple(sl_hi)] * w
    return Lut3D(table=np.ascontiguousarray(t.astype(np.float32)),
                 title=f"film{n}")


def _render_fps(prep, cfg, h, w, batch, rng) -> float:
    """Frames/s of the jitted render step (make_render_fn, the executor's
    program) on device-resident inputs."""
    import jax

    from lut_renderer_tpu.ops.render import make_render_fn
    from lut_renderer_tpu.utils.cardrun import yuv_batch

    y, u, v = (jax.device_put(a) for a in yuv_batch(rng, batch, h, w, cfg))
    return batch / _median_seconds(make_render_fn(prep, cfg), y, u, v)


def measure_configs(lut33) -> dict:
    """Render-step rates for the BASELINE config classes and the big-cube
    envelope (cube.py's MAX_LUT_SIZE = 129)."""
    from lut_renderer_tpu.ops import RenderConfig, prepare_lut

    rng = np.random.default_rng(2)
    prep33 = prepare_lut(lut33)
    film65 = _film_lut65()
    prep65 = prepare_lut(film65)
    out = {}
    out["fps_4k_65cube_tetra"] = _render_fps(
        prep65, RenderConfig(), H, W, 8, rng)
    # BASELINE config 2: 1080p, 10-bit source forced to 8-bit with dither
    out["fps_1080p_65cube_config2"] = _render_fps(
        prep65, RenderConfig(in_depth=10, out_depth=8, dither="ordered"),
        1080, 1920, 16, rng)
    # the per-device share of config 5: 8K 10-bit 4:2:2
    out["fps_8k_10bit_422_tetra"] = _render_fps(
        prep33, RenderConfig(in_depth=10, out_depth=10, in_subsampling="422",
                             out_subsampling="422"), 4320, 7680, 4, rng)
    # BASELINE config 1: 1080p 8-bit, trilinear fast delivery
    out["fps_1080p_trilinear_config1"] = _render_fps(
        prep33, RenderConfig(interp="trilinear"), 1080, 1920, 8, rng)
    # BASELINE config 3: two-stage pro mastering (ffmpeg.py:417-472)
    fps_m = _render_fps(
        prep33, RenderConfig(in_depth=10, out_depth=10, in_subsampling="422",
                             out_subsampling="422"), H, W, 8, rng)
    fps_d = _render_fps(
        prep33, RenderConfig(in_depth=10, out_depth=8, in_subsampling="422",
                             out_subsampling="420", dither="ordered",
                             apply_lut=False), H, W, 8, rng)
    out["fps_4k_pro_master"] = fps_m
    out["fps_4k_pro_stage2"] = fps_d
    out["fps_4k_pro_combined"] = 1.0 / (1.0 / fps_m + 1.0 / fps_d)
    # BASELINE config 4: 1080p full-range source normalized to tv
    out["fps_1080p_fullrange_config4"] = _render_fps(
        prep33, RenderConfig(in_full_range=True), 1080, 1920, 16, rng)
    for n in (97, 129):
        out[f"fps_4k_{n}cube_tetra"] = _render_fps(
            prepare_lut(_resampled(film65, n)), RenderConfig(), H, W, 2, rng)
    return out


def main() -> int:
    import jax

    from lut_renderer_tpu.utils.compile_cache import (
        enable_persistent_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py measures the accelerator; JAX found only the CPU",
              file=sys.stderr)
        return 2
    enable_persistent_compile_cache()
    lut, cube = _make_lut()
    result = {
        "metric": "4K frames/sec/device LUT-applied (tetrahedral 33^3); "
                  "max dE76 vs FFmpeg lut3d",
        "value": 0.0,
        "unit": "fps",
        "vs_baseline": 0.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card_info()},
    }
    try:
        cpu_fps = measure_cpu_fps(cube)
        result["cpu_baseline_fps"] = cpu_fps
    except Exception as exc:  # host FFmpeg build without libavfilter
        cpu_fps = None
        result["cpu_baseline_error"] = str(exc)[:200]
    fps = measure_lut_fps(lut)
    result["value"] = fps
    if cpu_fps:
        result["vs_baseline"] = fps / cpu_fps
    try:
        result["max_dE76_vs_lut3d"] = measure_kernel_parity(lut, cube)
    except Exception as exc:  # host FFmpeg build without libavfilter
        result["parity_error"] = str(exc)[:200]
    result.update(measure_configs(lut))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
