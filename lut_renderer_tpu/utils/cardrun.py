"""Inputs and device facts shared by the programs that run the render path
on an NVIDIA card: chip_smoke.py, bench.py, scripts/trace_render.py and the
card-only tests (tests/test_gpu.py).

Every input is made from a seed, so two runs (or a run and its NumPy
reference) see the same data.
"""

from __future__ import annotations

import subprocess

import numpy as np


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them. Raises where
    nvidia-smi cannot answer."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def noisy_lut(n: int, seed: int = 0, domain=None):
    """Identity n^3 LUT plus a bounded random grade (uniform +-0.05,
    clipped to [0, 1]), optionally over a non-unit domain
    ((min rgb), (max rgb))."""
    from ..colorcore import Lut3D

    rng = np.random.default_rng(seed + n)
    lut = Lut3D.identity(n)
    lut.table = np.clip(
        lut.table + rng.uniform(-0.05, 0.05, lut.table.shape
                                ).astype(np.float32), 0, 1)
    if domain is not None:
        lut.domain_min = np.asarray(domain[0], np.float32)
        lut.domain_max = np.asarray(domain[1], np.float32)
    return lut


def yuv_batch(rng, batch: int, h: int, w: int, cfg, full_scale: bool = False):
    """Random (y, u, v) code-value planes at cfg's input depth and
    subsampling: within the legal range of cfg's input range, or over every
    code value with `full_scale`."""
    d = cfg.in_depth
    if full_scale or cfg.in_full_range:
        ylo, yhi, clo, chi = 0, (1 << d) - 1, 0, (1 << d) - 1
    else:
        s = 1 << (d - 8)
        ylo, yhi, clo, chi = 16 * s, 235 * s, 16 * s, 240 * s
    dt = np.uint16 if d > 8 else np.uint8
    hc = h // 2 if cfg.in_subsampling == "420" else h
    wc = w // 2 if cfg.in_subsampling in ("420", "422") else w
    y = rng.integers(ylo, yhi + 1, (batch, h, w)).astype(dt)
    u = rng.integers(clo, chi + 1, (batch, hc, wc)).astype(dt)
    v = rng.integers(clo, chi + 1, (batch, hc, wc)).astype(dt)
    return y, u, v
