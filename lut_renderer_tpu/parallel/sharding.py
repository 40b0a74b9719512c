"""Multi-chip frame sharding over a jax.sharding.Mesh.

The reference's only parallelism is N independent FFmpeg processes
(SURVEY.md §2.3); this build adds intra-clip data parallelism: the frame
batch axis is sharded across devices (BASELINE.json config 5,
"frame-sharded multi-chip pipeline"). Frames are independent, so the render
step needs NO collectives — sharding the batch axis with shard_map keeps
each device's render local to its shard. The mesh is one flat `frames`
axis: the devices of one host reach each other all to all.

The LUT table and config are replicated; host I/O feeds per-device shards
via jax.device_put with a NamedSharding so H2D copies land directly on the
right devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.prepare import PreparedLut
from ..ops.render import RenderConfig, render_yuv_frame

FRAME_AXIS = "frames"


def default_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (FRAME_AXIS,))


def shard_batch_size(mesh: Mesh, per_device_frames: int = 1) -> int:
    return mesh.shape[FRAME_AXIS] * per_device_frames


def make_sharded_render_fn(
    prep: Optional[PreparedLut],
    cfg: RenderConfig,
    mesh: Mesh,
):
    """Jitted render step over a mesh: batch axis sharded, LUT replicated.

    Inputs: y (B, H, W), u/v (B, Hc, Wc) with B a multiple of the mesh size.
    Frames are independent -> out_specs mirror in_specs and XLA inserts no
    collectives.
    """
    spec = P(FRAME_AXIS)
    table_np = prep.table if prep is not None and cfg.apply_lut else None

    def step(y, u, v, table):
        return render_yuv_frame(y, u, v, prep, cfg, lut_table=table)

    # The LUT table rides as a REPLICATED argument: device_put once below,
    # so the compiled program is LUT-agnostic and no per-step table traffic
    # crosses devices.
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(spec, spec, spec, None if table_np is None else P()),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    jitted = jax.jit(sharded)
    table_dev = (None if table_np is None else jax.device_put(
        table_np, NamedSharding(mesh, P())))
    return lambda y, u, v: jitted(y, u, v, table_dev)


def put_sharded(mesh: Mesh, *arrays):
    """Host arrays -> device arrays sharded along the frame axis."""
    sharding = NamedSharding(mesh, P(FRAME_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)
