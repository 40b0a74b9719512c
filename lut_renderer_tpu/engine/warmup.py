"""Compile-cache warm-start: precompile the production program set.

A cold process pays one compile per program shape; the persistent XLA cache
(utils.compile_cache) makes repeats cheap, but a cold daemon's first job
would otherwise eat the full set. Compiled programs are LUT-AGNOSTIC — the
table rides as a jit argument (ops.render.make_render_fn), so programs are
keyed by (frame shape, batch, LUT size, interp, domain), not table values —
and warming with synthetic LUTs serves real .cube files with zero compiles.

Driven by `lut-tpu serve --warmup` / `lut-tpu doctor --warmup`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class WarmupProgram:
    label: str
    width: int
    height: int
    lut_size: int
    interp: str = "tetrahedral"
    in_depth: int = 8
    out_depth: int = 8
    in_subsampling: str = "420"
    out_subsampling: str = "420"
    dither: str = "none"


# The production set: the BASELINE config classes users actually hit.
DEFAULT_PROGRAMS: List[WarmupProgram] = [
    WarmupProgram("1080p 33^3 tetra", 1920, 1080, 33),
    WarmupProgram("4K 33^3 tetra", 3840, 2160, 33),
    WarmupProgram("4K 65^3 tetra", 3840, 2160, 65),
    WarmupProgram("1080p 65^3 tetra 10->8bit dither", 1920, 1080, 65,
                  in_depth=10, in_subsampling="422", dither="ordered"),
    WarmupProgram("8K 33^3 tetra 10-bit", 7680, 4320, 33,
                  in_depth=10, out_depth=10, in_subsampling="422",
                  out_subsampling="422"),
]


def _bucket_programs() -> List[WarmupProgram]:
    """The geometry-bucket ladder (engine.geometry.BUCKETS): one program
    per bucket for the ad hoc serving class (8-bit 4:2:0, the web-submit
    shape), plus the DCI pro-master class at its bucket. The 8K bucket is
    left to compile-on-first-use (ad hoc 8K is rare and the exact 8K 10-bit
    program above covers production)."""
    from .geometry import BUCKETS

    out = []
    for bw, bh in BUCKETS:
        if (bw, bh) == (7680, 4320):
            continue
        out.append(WarmupProgram(f"bucket {bw}x{bh} 33^3", bw, bh, 33))
    out.append(WarmupProgram("bucket 4096x2304 33^3 10-bit 422 (DCI pro)",
                             4096, 2304, 33, in_depth=10, out_depth=10,
                             in_subsampling="422", out_subsampling="422"))
    return out


DEFAULT_PROGRAMS += _bucket_programs()


def _synthetic_prep(size: int):
    from ..colorcore import Lut3D
    from ..ops import prepare_lut

    rng = np.random.default_rng(7)
    lut = Lut3D.identity(size)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.02, 0.02, lut.table.shape
                                ).astype(np.float32), 0, 1)
    return prepare_lut(lut)


def _warm_one(prog: WarmupProgram, batch_size: Optional[int],
              log: Callable[[str], None]) -> dict:
    import jax

    from ..ops.render import RenderConfig, make_render_fn
    from .executor import _pick_batch_size

    prep = _synthetic_prep(prog.lut_size)
    bsz = batch_size or _pick_batch_size(prog.width, prog.height)
    w, h = prog.width, prog.height
    dt_y = np.uint8 if prog.in_depth == 8 else np.uint16
    y = np.zeros((bsz, h, w), dt_y)
    cw = w if prog.in_subsampling == "444" else w // 2
    ch = h if prog.in_subsampling != "420" else h // 2
    u = np.zeros((bsz, ch, cw), dt_y)
    v = np.zeros((bsz, ch, cw), dt_y)
    cfg = RenderConfig(
        interp=prog.interp,
        in_depth=prog.in_depth, out_depth=prog.out_depth,
        in_subsampling=prog.in_subsampling,
        out_subsampling=prog.out_subsampling,
        dither=prog.dither,
    )
    t0 = time.perf_counter()
    try:
        fn = make_render_fn(prep, cfg)
        jax.block_until_ready(fn(y, u, v))
        dt = time.perf_counter() - t0
        rec = {"label": prog.label, "batch": bsz,
               "seconds": round(dt, 2), "cache_hit": dt < 5.0, "ok": True}
    except Exception as exc:  # pragma: no cover - device-specific
        dt = time.perf_counter() - t0
        rec = {"label": prog.label, "batch": bsz,
               "seconds": round(dt, 2), "ok": False,
               "error": str(exc)[:200]}
    log(f"warmup: {rec['label']} batch={rec['batch']} "
        + (f"{'cache hit' if rec.get('cache_hit') else 'compiled'} "
           f"in {rec['seconds']}s" if rec["ok"]
           else f"FAILED: {rec.get('error')}"))
    return rec


def warmup_programs(
    log: Optional[Callable[[str], None]] = None,
    programs: Optional[Sequence[WarmupProgram]] = None,
    batch_size: Optional[int] = None,
    workers: Optional[int] = None,
) -> List[dict]:
    """Compile-and-run each production program once on tiny-value inputs.

    Returns one record per program: label, batch, seconds, and whether it
    looked like a cache hit (sub-5s wall including the run).
    Uses the SAME entry points as the executor (make_render_fn with the
    table as an argument + the executor's batch-size rule) so the warmed programs are
    byte-identical to what jobs run.

    workers: programs compile concurrently on this many threads (jit
    tracing is thread-safe, and the cache lock in ops.render serializes
    only the fn-cache insert). Default 1; override with
    LUT_TPU_WARMUP_WORKERS."""
    import os

    log = log or (lambda m: None)
    if programs is not None:
        progs = list(programs)
    else:
        from .geometry import geometry_mode

        # don't spend minutes warming bucket programs no job can route to
        buckets_active = geometry_mode() == "bucket"
        progs = [p for p in DEFAULT_PROGRAMS
                 if buckets_active or not p.label.startswith("bucket ")]
    if workers is None:
        try:
            workers = int(os.environ.get("LUT_TPU_WARMUP_WORKERS", "1"))
        except ValueError:
            workers = 1
    workers = max(1, min(workers, len(progs) or 1))
    if workers == 1:
        return [_warm_one(prog, batch_size, log) for prog in progs]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(_warm_one, prog, batch_size, log)
                   for prog in progs]
        # program order, regardless of completion order
        return [fut.result() for fut in futures]
