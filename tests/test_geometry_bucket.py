"""Geometry bucketing (engine.geometry): ad hoc resolutions ride
precompiled bucket-shaped programs via host pad-and-crop.

The reference serves ANY geometry with zero warmup (its FFmpeg filter
chain is an interpreter, reference ffmpeg.py:189-193, 242-247); shape-keyed
XLA programs must not turn that into minutes of compile. These tests pin:

* the bucket-selection policy (opt-in with LUT_TPU_GEOMETRY=bucket, round
  up, production shapes exempt; "auto" runs exact shapes);
* BIT-exactness of pad->render->crop vs the direct render for every
  pipeline stage class that touches geometry (chroma up/downsampling in
  all sitings, position-anchored dithers, range requantize, the row-phase
  layout, float error-diffusion outputs);
* the executor end-to-end: a bucketed run produces byte-identical output
  to an exact-shape run through a lossless encoder.
"""

import numpy as np
import pytest

from lut_renderer_tpu.engine import geometry
from lut_renderer_tpu.engine.geometry import (
    crop_batch_from_bucket,
    pad_batch_to_bucket,
    pick_bucket,
)
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.ops.render import RenderConfig, render_yuv_frame


@pytest.fixture()
def bucket_mode(monkeypatch):
    monkeypatch.setenv("LUT_TPU_GEOMETRY", "bucket")


def test_pick_bucket_policy(bucket_mode):
    # the VERDICT's named ad hoc cases
    assert pick_bucket(640, 360) == (640, 368)
    assert pick_bucket(4096, 1716) == (4096, 2304)  # DCI scope
    assert pick_bucket(1080, 1920) == (1152, 1920)  # portrait phone
    assert pick_bucket(854, 480) == (1024, 576)
    assert pick_bucket(2048, 1080) == (2560, 1440)
    # production geometries keep their exact-shape programs
    for w, h in ((1920, 1080), (3840, 2160), (7680, 4320)):
        assert pick_bucket(w, h) is None
    # a shape that IS a bucket needs no second program
    assert pick_bucket(1280, 720) is None
    # beyond the ladder -> exact
    assert pick_bucket(9000, 5000) is None


def test_mode_policy(monkeypatch):
    # default, the older "exact" and "auto" values and unknown values all
    # run exact shapes: bucketing is the explicit mode until a measurement
    # on the device says it pays
    for value in ("exact", "auto", "nonsense"):
        monkeypatch.setenv("LUT_TPU_GEOMETRY", value)
        assert geometry.geometry_mode() == "exact"
        assert pick_bucket(640, 360) is None
    monkeypatch.delenv("LUT_TPU_GEOMETRY", raising=False)
    assert geometry.geometry_mode() == "exact"
    assert pick_bucket(640, 360) is None
    monkeypatch.setenv("LUT_TPU_GEOMETRY", "bucket")
    assert pick_bucket(640, 360) == (640, 368)


def test_warmup_skips_buckets_when_unroutable(monkeypatch):
    """`serve --warmup` must not spend minutes compiling bucket programs
    no job can route to (the default exact mode, however it is named)."""
    from lut_renderer_tpu.engine import warmup as W

    captured = {}

    def fake_warm(prog, batch_size, log):
        captured.setdefault("labels", []).append(prog.label)
        return {"label": prog.label, "ok": True}

    monkeypatch.setattr(W, "_warm_one", fake_warm)
    monkeypatch.setenv("LUT_TPU_GEOMETRY", "exact")
    W.warmup_programs()
    assert not any(l.startswith("bucket ") for l in captured["labels"])
    n_exact = len(captured["labels"])
    captured.clear()
    monkeypatch.setenv("LUT_TPU_GEOMETRY", "auto")
    W.warmup_programs()
    assert len(captured["labels"]) == n_exact
    captured.clear()
    monkeypatch.setenv("LUT_TPU_GEOMETRY", "bucket")
    W.warmup_programs()
    assert any(l.startswith("bucket ") for l in captured["labels"])
    assert len(captured["labels"]) > n_exact


def _planes(rng, w, h, subsampling, depth):
    cw, ch = geometry._chroma_dims(w, h, subsampling)
    hi = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    return (rng.integers(0, hi + 1, (2, h, w)).astype(dt),
            rng.integers(0, hi + 1, (2, ch, cw)).astype(dt),
            rng.integers(0, hi + 1, (2, ch, cw)).astype(dt))


CASES = [
    # (label, cfg overrides, bucket)
    ("base 420", {}, (128, 64)),
    ("ordered dither", {"dither": "ordered"}, (128, 64)),
    ("random dither", {"dither": "random"}, (128, 64)),
    ("bilinear chroma", {"chroma_up": "bilinear"}, (128, 64)),
    ("422p10 -> 422p10", {"in_depth": 10, "out_depth": 10,
                          "in_subsampling": "422",
                          "out_subsampling": "422"}, (128, 64)),
    ("444 -> 420", {"in_subsampling": "444"}, (128, 64)),
    ("full-range in + requantize", {"in_full_range": True}, (128, 64)),
    ("ED host (float out)", {"dither": "error_diffusion_host"}, (128, 64)),
]


@pytest.mark.parametrize("label,overrides,bucket",
                         CASES, ids=[c[0] for c in CASES])
def test_pad_crop_bit_exact(rng, random_lut, label, overrides, bucket):
    """pad -> render -> crop == direct render, EXACTLY, for every config
    class whose stages touch geometry. Bucket dims are arbitrary to the
    math (only the ladder is policy), so small ones keep CPU time down."""
    prep = prepare_lut(random_lut)
    cfg = RenderConfig(**overrides)
    w, h = 100, 56
    y, u, v = _planes(rng, w, h, cfg.in_subsampling, cfg.in_depth)

    direct = render_yuv_frame(y, u, v, prep, cfg)
    yp, up, vp = pad_batch_to_bucket(y, u, v, bucket, cfg.in_subsampling)
    assert yp.shape[-2:] == (bucket[1], bucket[0])
    padded = render_yuv_frame(yp, up, vp, prep, cfg)
    cropped = crop_batch_from_bucket(*(np.asarray(p) for p in padded),
                                     w, h, cfg.out_subsampling)
    for d, c in zip(direct, cropped):
        d = np.asarray(d)
        assert d.shape == c.shape
        assert np.array_equal(d, c), label


def test_pad_crop_bit_exact_rowphase_layout(rng, random_lut):
    """The row-phase 4:2:0 layout under pad-and-crop: the path ad hoc
    8-bit 4:2:0 web submits actually take."""
    prep = prepare_lut(random_lut)
    cfg = RenderConfig(phase_layout="rowphase", dither="ordered")
    w, h = 100, 56
    y, u, v = _planes(rng, w, h, "420", 8)
    direct = render_yuv_frame(y, u, v, prep, cfg)
    yp, up, vp = pad_batch_to_bucket(y, u, v, (256, 64), "420")
    padded = render_yuv_frame(yp, up, vp, prep, cfg)
    cropped = crop_batch_from_bucket(*(np.asarray(p) for p in padded),
                                     w, h, "420")
    for d, c in zip(direct, cropped):
        assert np.array_equal(np.asarray(d), c)


def test_executor_bucketed_run_matches_exact(tmp_path, monkeypatch,
                                             random_lut):
    """End to end through run_stage: the bucketed engine path produces a
    byte-identical file to the exact-shape path (lossless encoder), and
    logs that the bucket program was used."""
    from lut_renderer_tpu.colorcore import write_cube_file
    from lut_renderer_tpu.engine import run_stage
    from lut_renderer_tpu.hostio import probe_video
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan import build_render_spec
    from lut_renderer_tpu.tasks.runner import load_prepared_lut
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    clip = make_gradient_clip(tmp_path / "c.mp4", 100, 56, fps=25.0,
                              frames=5)
    cube = write_cube_file(tmp_path / "l.cube", random_lut)
    info = probe_video(clip)
    prep = load_prepared_lut(cube)
    params = ProcessingParams(video_codec="ffv1", audio_codec="")

    outs, logs = {}, {}
    for mode in ("exact", "bucket"):
        monkeypatch.setenv("LUT_TPU_GEOMETRY", mode)
        out = tmp_path / f"out_{mode}.mkv"
        lines = []
        spec = build_render_spec(source=clip, output=out, params=params,
                                 lut_path=cube, source_info=info)
        res = run_stage(spec, info, prep, log_cb=lines.append)
        assert res.ok, res.error
        outs[mode] = out
        logs[mode] = "\n".join(lines)

    assert "bucket program" in logs["bucket"]
    assert "bucket program" not in logs["exact"]
    # identical pixels through the lossless codec (container headers carry
    # a random segment UID, so compare decoded planes, not file bytes)
    from lut_renderer_tpu.hostio.decode import VideoDecoder

    da, db = VideoDecoder(outs["exact"]), VideoDecoder(outs["bucket"])
    n = 0
    for fa, fb in zip(da, db):
        for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v)):
            assert np.array_equal(pa, pb)
        n += 1
    da.close(), db.close()
    assert n == 5


def test_identity_resize_is_normalized_away(tmp_path, monkeypatch,
                                            random_lut):
    """taskfactory's smart defaults echo the source size into
    `resolution` (reference behavior), which used to force an identity
    resize: the plain layout + two no-op matmuls AND an exact-shape
    program class that silently disabled geometry bucketing for every
    queued job (round-5 wedged-soak catch). The executor must drop a
    resize equal to the source dims, and the result must be identical
    to the blank-resolution run."""
    from lut_renderer_tpu.colorcore import write_cube_file
    from lut_renderer_tpu.engine import run_stage
    from lut_renderer_tpu.hostio import probe_video
    from lut_renderer_tpu.hostio.decode import VideoDecoder
    from lut_renderer_tpu.models import ProcessingParams
    from lut_renderer_tpu.plan import build_render_spec
    from lut_renderer_tpu.tasks.runner import load_prepared_lut
    from lut_renderer_tpu.utils.fixtures import make_gradient_clip

    monkeypatch.setenv("LUT_TPU_GEOMETRY", "bucket")
    clip = make_gradient_clip(tmp_path / "c.mp4", 100, 56, fps=25.0,
                              frames=4)
    cube = write_cube_file(tmp_path / "l.cube", random_lut)
    info = probe_video(clip)
    prep = load_prepared_lut(cube)

    outs = {}
    for tag, resolution in (("echo", "100x56"), ("blank", "")):
        params = ProcessingParams(video_codec="ffv1", audio_codec="",
                                  resolution=resolution)
        lines = []
        spec = build_render_spec(source=clip,
                                 output=tmp_path / f"o_{tag}.mkv",
                                 params=params, lut_path=cube,
                                 source_info=info)
        res = run_stage(spec, info, prep, log_cb=lines.append)
        assert res.ok, res.error
        # the echoed size must NOT force the exact-shape/resize class
        assert "bucket program" in "\n".join(lines), (tag, lines)
        outs[tag] = tmp_path / f"o_{tag}.mkv"

    da, db = VideoDecoder(outs["echo"]), VideoDecoder(outs["blank"])
    for fa, fb in zip(da, db):
        for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v)):
            assert np.array_equal(pa, pb)
    da.close(), db.close()


def test_pad_rejects_oversize():
    y = np.zeros((1, 80, 80), np.uint8)
    u = v = np.zeros((1, 40, 40), np.uint8)
    with pytest.raises(ValueError, match="exceeds bucket"):
        pad_batch_to_bucket(y, u, v, (64, 64), "420")
