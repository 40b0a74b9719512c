#!/usr/bin/env python3
"""Where the render step's device time goes, from a jax.profiler trace.

Run on the machine with the card, from the repository root:

    python scripts/trace_render.py [--out chiprun_out/trace_render.json]

For each cell (4K 8-bit 4:2:0 33^3, the executor's batch of 2; 8K 10-bit
4:2:2 33^3, batch 1) it compiles the jitted render step, times ITERS calls
on device-resident inputs (host clock around block_until_ready), traces
TRACED more calls, and reduces the trace to:

  * ms per frame (host clock, profiler off) and device busy share of the
    traced window (union of kernel intervals over the window);
  * the step's roofline share: the least bytes it must move (its input
    and output planes) over peak bandwidth, divided by its device kernel
    time;
  * the top kernels by device time, each with XLA's own bytes-accessed
    estimate of its instruction (xla_bytes_by_instruction) over peak
    bandwidth and kernel time. The estimate counts bytes the kernel reads
    and writes, wherever they come from: a kernel whose operands sit in
    the card's 50 MB L2 can exceed a share of 1, so the share bounds its
    HBM traffic from above. The program's total estimate is recorded
    beside the sum over instructions, which checks the split.

It also times a plain large device copy, the achievable-bandwidth yardstick
for the same card. Peak bandwidth comes from PEAKS, keyed by device_kind; a
device not in the table is an error. The card's name and power limit are
recorded beside the numbers.
"""

import argparse
import glob
import json
import re
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# device_kind -> HBM bytes/s (NVIDIA H100 SXM data sheet: 80 GB HBM3 at
# 3.35 TB/s, at the full 700 W power limit).
PEAKS = {"NVIDIA H100 80GB HBM3": 3.35e12}
ITERS = 10
TRACED = 3

# One instruction line of the compiled ENTRY computation: name, result
# shape, opcode; the operands and attributes follow the opening parenthesis.
_HEAD = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s+"
                   r"([a-z][\w\-]*)\(")
# Instructions that move no data of their own.
_NO_TRAFFIC = {"parameter", "constant", "get-tuple-element", "tuple",
               "bitcast"}


def _entry_instructions(hlo_text: str):
    """(text before ENTRY, text after it, [(name, shape, opcode, operand
    names, attributes)]) of a module's HLO text."""
    start = hlo_text.index("\nENTRY")
    end = hlo_text.index("\n}", start)
    instrs = []
    for line in hlo_text[start:end].splitlines()[2:]:
        m = _HEAD.match(line)
        if not m:
            continue
        depth, i = 0, m.end() - 1
        for j in range(i, len(line)):
            depth += {"(": 1, ")": -1}.get(line[j], 0)
            if depth == 0:
                break
        instrs.append((m.group(1), m.group(2), m.group(3),
                       re.findall(r"%([\w.\-]+)", line[i + 1:j]),
                       line[j + 1:]))
    return hlo_text[:start], hlo_text[end + 2:], instrs


def xla_bytes_by_instruction(hlo_text: str, errors=None) -> dict:
    """XLA's own bytes-accessed estimate for each instruction of the
    compiled ENTRY computation, keyed by instruction name.

    Each instruction is put alone into a module, with a parameter for each
    operand and the module's other computations (fusion bodies) as they
    are, and XLA's cost analysis runs on that module. For a fusion this is
    the estimate XLA's cost model makes of it, including what it knows of
    operands read only in part. The sum over instructions equals the cost
    analysis of the whole program (`compiled.cost_analysis()`), which
    checks the split. An instruction the cost analysis rejects maps to
    None, with the reason in `errors` where a dict is given."""
    import jax
    from jax._src.lib import xla_client

    # the GPU plugin's client has no HLO cost analysis; the host's does,
    # and it reads any backend's compiled HLO
    client = jax.devices("cpu")[0].client
    errors = {} if errors is None else errors
    head, tail, instrs = _entry_instructions(hlo_text)
    # the HloModule line names the old ENTRY's layout; the probe has its own
    computations = head[head.index("\n"):]
    shapes = {name: shape for name, shape, *_ in instrs}
    out = {}
    for name, shape, op, operands, attrs in instrs:
        if op in _NO_TRAFFIC:
            continue
        params = ", ".join(f"p{k}: {shapes[o]}"
                           for k, o in enumerate(operands))
        body = [f"  %p{k} = {shapes[o]} parameter({k})"
                for k, o in enumerate(operands)]
        args = ", ".join(f"%p{k}" for k in range(len(operands)))
        # scheduling edges name instructions the probe does not have
        attrs = re.sub(r",\s*control-predecessors=\{[^}]*\}", "", attrs)
        body.append(f"  ROOT %{name} = {shape} {op}({args}){attrs}")
        text = (f"HloModule probe{computations}\nENTRY %probe ({params}) -> "
                f"{shape} {{\n" + "\n".join(body) + "\n}\n" + tail)
        try:
            cost = xla_client._xla.hlo_module_cost_analysis(
                client, xla_client._xla.hlo_module_from_text(text))
            out[name] = cost.get("bytes accessed")
        except Exception as exc:
            out[name] = None
            errors[name] = str(exc)[:500]
    return out


def reduce_trace(trace_dir: str, calls: int) -> dict:
    """Device kernel time by name and busy share, from the xplane file."""
    from jax.profiler import ProfileData

    path = glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb")[0]
    device_lines, lines_seen = [], []
    for plane in ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                lines_seen.append(f"{plane.name}:{line.name}")
                device_lines.append(line)
    # Kernel events live on the stream lines; the "XLA Modules" and "XLA
    # Ops" lines repeat the same time at other granularities. Fall back to
    # "XLA Ops" where a profiler build names no stream line.
    chosen = ([ln for ln in device_lines if ln.name.startswith("Stream")]
              or [ln for ln in device_lines if ln.name == "XLA Ops"])
    per_name = defaultdict(float)
    intervals = []
    for line in chosen:
        for ev in line.events:
            per_name[ev.name] += ev.duration_ns
            intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError(f"no device kernel events; lines: {lines_seen}")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return {"lines": lines_seen, "busy_ns": busy, "window_ns": window,
            "per_call_ns": {k: v / calls for k, v in per_name.items()}}


def run_cell(label, w, h, batch, cfg_kwargs, peak) -> dict:
    import jax

    from lut_renderer_tpu.ops import RenderConfig, prepare_lut
    from lut_renderer_tpu.ops.render import render_yuv_frame
    from lut_renderer_tpu.utils.cardrun import noisy_lut, yuv_batch

    cfg = RenderConfig(**cfg_kwargs)
    prep = prepare_lut(noisy_lut(33))
    y, u, v = (jax.device_put(a) for a in
               yuv_batch(np.random.default_rng(0), batch, h, w, cfg))
    table = jax.device_put(prep.table)
    step = jax.jit(lambda y, u, v, t: render_yuv_frame(y, u, v, prep, cfg,
                                                       lut_table=t))
    t0 = time.perf_counter()
    compiled = step.lower(y, u, v, table).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(y, u, v, table))
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(y, u, v, table))
        times.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tdir:
        jax.profiler.start_trace(tdir)
        for _ in range(TRACED):
            jax.block_until_ready(compiled(y, u, v, table))
        jax.profiler.stop_trace()
        tr = reduce_trace(tdir, TRACED)
    xb_errors = {}
    xb = xla_bytes_by_instruction(compiled.as_text(), xb_errors)
    kernels = []
    for name, ns in sorted(tr["per_call_ns"].items(), key=lambda kv: -kv[1]):
        nbytes = xb.get(name.split(" ")[0])
        kernels.append({
            "name": name, "us_per_call": ns / 1e3,
            "share_of_kernel_time": ns / sum(tr["per_call_ns"].values()),
            "xla_bytes_accessed": nbytes,
            "xla_bytes_share_of_peak": (nbytes / peak / (ns * 1e-9)
                                        if nbytes else None),
        })
    total_ns = sum(tr["per_call_ns"].values())
    out = compiled(y, u, v, table)
    io_bytes = sum(a.size * a.dtype.itemsize for a in (y, u, v, *out))
    return {
        "cell": label, "batch": batch, "compile_s": compile_s,
        "ms_per_frame_host_clock": float(np.median(times)) * 1e3 / batch,
        "ms_per_frame_samples": [t * 1e3 / batch for t in times],
        "device_kernel_ms_per_call": total_ns / 1e6,
        "device_busy_share_traced": tr["busy_ns"] / tr["window_ns"],
        "io_bytes_per_call": io_bytes,
        "io_roofline_ms_per_call": io_bytes / peak * 1e3,
        "xla_bytes_accessed_program": compiled.cost_analysis().get(
            "bytes accessed"),
        "xla_bytes_accessed_sum_of_instructions": sum(
            b for b in xb.values() if b),
        "instructions_without_estimate": xb_errors,
        "roofline_share": io_bytes / peak / (total_ns * 1e-9),
        "memory_analysis": str(compiled.memory_analysis()),
        "top_kernels": kernels[:10],
        "n_kernels": len(kernels),
        "trace_lines": tr["lines"],
    }


def copy_bandwidth() -> float:
    """Bytes/s of a plain 1 GiB f32 read-modify-write on the device."""
    import jax

    x = jax.device_put(np.ones((256, 1024, 1024), np.float32))
    f = jax.jit(lambda a: a * 1.0001 + 1.0)
    jax.block_until_ready(f(x))
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        times.append(time.perf_counter() - t0)
    return 2 * x.nbytes / float(np.median(times))


def main() -> int:
    import jax

    from lut_renderer_tpu.utils.cardrun import card_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "chiprun_out"
                                             / "trace_render.json"))
    args = parser.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {dev.platform}")
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no peak bandwidth recorded for {dev.device_kind!r}")
    peak = PEAKS[dev.device_kind]
    result = {"device_kind": dev.device_kind, "card": card_line(),
              "jax": jax.__version__, "peak_hbm_bytes_per_s": peak,
              "copy_bytes_per_s": copy_bandwidth(), "cells": []}
    for label, w, h, batch, kw in (
            ("4K 8-bit 4:2:0 33^3 tetrahedral", 3840, 2160, 2, {}),
            ("8K 10-bit 4:2:2 33^3 tetrahedral", 7680, 4320, 1,
             dict(in_depth=10, out_depth=10, in_subsampling="422",
                  out_subsampling="422"))):
        result["cells"].append(run_cell(label, w, h, batch, kw, peak))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    for c in result["cells"]:
        print(f"{c['cell']}: {c['ms_per_frame_host_clock']:.3f} ms/frame, "
              f"kernels {c['device_kernel_ms_per_call']:.3f} ms/call, "
              f"busy {c['device_busy_share_traced']:.3f}, "
              f"roofline share {c['roofline_share']:.4f}")
        for k in c["top_kernels"][:6]:
            rs = k["xla_bytes_share_of_peak"]
            print(f"   {k['us_per_call']:9.1f} us  "
                  f"{'-' if rs is None else f'{rs:.2f}'}  {k['name'][:90]}")
    print(f"card: {result['card']}; copy "
          f"{result['copy_bytes_per_s'] / 1e12:.3f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
