"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from lut_renderer_tpu.colorcore import Lut3D
from lut_renderer_tpu.ops import RenderConfig, prepare_lut
from lut_renderer_tpu.ops.render import render_yuv_frame
from lut_renderer_tpu.parallel import (
    default_mesh,
    make_sharded_render_fn,
    shard_batch_size,
)
from lut_renderer_tpu.parallel.sharding import put_sharded


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must fan out 8 CPU devices"
    return default_mesh()


def _inputs(rng, batch, h=32, w=128):
    y = rng.integers(16, 236, (batch, h, w), dtype=np.uint8)
    u = rng.integers(16, 241, (batch, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(16, 241, (batch, h // 2, w // 2), dtype=np.uint8)
    return y, u, v


def test_sharded_matches_single_device(mesh, rng, random_lut):
    prep = prepare_lut(random_lut)
    cfg = RenderConfig(interp="tetrahedral")
    batch = shard_batch_size(mesh, per_device_frames=2)
    assert batch == 16
    y, u, v = _inputs(rng, batch)
    fn = make_sharded_render_fn(prep, cfg, mesh)
    ys, us, vs = put_sharded(mesh, y, u, v)
    yq, uq, vq = fn(ys, us, vs)
    ref = render_yuv_frame(y, u, v, prep, cfg)
    for got, want in ((yq, ref[0]), (uq, ref[1]), (vq, ref[2])):
        diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize(
    "size,depth,interp",
    [
        (33, 8, "tetrahedral"),   # the headline 4K class
        (33, 10, "tetrahedral"),  # 10-bit in/out
        (65, 8, "tetrahedral"),   # config 2's LUT size
        (65, 10, "trilinear"),
        (17, 8, "prism"),
    ],
)
def test_sharded_lut_sizes_match_single_device(mesh, rng, size, depth,
                                               interp):
    """The render step under shard_map with the LUT table replicated, over
    LUT sizes, depths and interps, against the unsharded step."""
    lut = Lut3D.identity(size)
    lut.table = np.clip(
        lut.table
        + rng.uniform(-0.03, 0.03, lut.table.shape).astype(np.float32),
        0, 1)
    prep = prepare_lut(lut)
    cfg = RenderConfig(interp=interp, in_depth=depth, out_depth=depth)
    batch = shard_batch_size(mesh, per_device_frames=2)
    if depth == 8:
        y, u, v = _inputs(rng, batch)
    else:
        h, w = 32, 128
        y = rng.integers(64, 940, (batch, h, w)).astype(np.uint16)
        u = rng.integers(64, 960, (batch, h // 2, w // 2)).astype(np.uint16)
        v = rng.integers(64, 960, (batch, h // 2, w // 2)).astype(np.uint16)
    fn = make_sharded_render_fn(prep, cfg, mesh)
    ys, us, vs = put_sharded(mesh, y, u, v)
    yq, uq, vq = fn(ys, us, vs)
    ref = render_yuv_frame(y, u, v, prep, cfg)
    for got, want in ((yq, ref[0]), (uq, ref[1]), (vq, ref[2])):
        diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3
    assert len(yq.sharding.device_set) == 8  # stays frame-sharded


def test_sharded_output_sharding_preserved(mesh, rng, identity_lut):
    """Outputs stay sharded along the frame axis (no implicit gather)."""
    prep = prepare_lut(identity_lut)
    cfg = RenderConfig()
    y, u, v = _inputs(rng, 8)
    fn = make_sharded_render_fn(prep, cfg, mesh)
    ys, us, vs = put_sharded(mesh, y, u, v)
    yq, _, _ = fn(ys, us, vs)
    assert len(yq.sharding.device_set) == 8


def test_graft_entry_dryrun():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def _graft_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graft_entry_forward():
    """entry() is a real 4K batch: compile and run it, and check the
    planes that come out against its traced shapes and dtypes."""
    fn, args = _graft_module("graft_entry2").entry()
    assert args[0].shape == (2, 2160, 3840) and args[1].shape == (2, 1080, 1920)
    traced = jax.eval_shape(fn, *args)
    out = jax.block_until_ready(jax.jit(fn)(*args))
    assert [(o.shape, o.dtype) for o in out] == [
        (t.shape, t.dtype) for t in traced]
    assert [o.shape for o in out] == [a.shape for a in args]
    assert all(o.dtype == np.uint8 for o in out)


def test_graft_dryrun_refuses_cpu_fallback(monkeypatch):
    """On an accelerator with too few devices the dry run fails instead of
    quietly re-running itself on the CPU; only an explicit
    JAX_PLATFORMS=cpu rehearsal re-runs on virtual devices."""
    mod = _graft_module("graft_entry3")

    class _Dev:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    spawned = []
    monkeypatch.setattr(mod.subprocess, "run",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="only 1 gpu device"):
        mod.dryrun_multichip(4)
    assert not spawned


def test_sharded_10bit_8k_class_tiles(mesh, rng, random_lut):
    """Config-5 shape class: 10-bit frames sharded over the mesh (one
    8K-aspect tile per device; the full-size 8K run over four GPUs is
    `python chip_smoke.py --multi`)."""
    from lut_renderer_tpu.ops.render import RenderConfig as RC

    prep = prepare_lut(random_lut)
    cfg = RC(in_depth=10, out_depth=10, interp="tetrahedral")
    batch = shard_batch_size(mesh)
    h, w = 54, 192  # 8K aspect (16:9), tiny for the CPU mesh
    y = rng.integers(64, 940, (batch, h, w)).astype(np.uint16)
    u = rng.integers(64, 960, (batch, h // 2, w // 2)).astype(np.uint16)
    v = rng.integers(64, 960, (batch, h // 2, w // 2)).astype(np.uint16)
    fn = make_sharded_render_fn(prep, cfg, mesh)
    ys, us, vs = put_sharded(mesh, y, u, v)
    yq, uq, vq = fn(ys, us, vs)
    ref = render_yuv_frame(y, u, v, prep, cfg)
    for got, want in ((yq, ref[0]), (uq, ref[1]), (vq, ref[2])):
        assert got.dtype == np.uint16
        diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
        assert diff.max() <= 1
