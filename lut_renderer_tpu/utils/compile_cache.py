"""Persistent XLA compilation cache for production startup latency.

The first jit compile of a render program costs seconds; for a batch tool
that is per-PROCESS overhead the reference never had (FFmpeg binaries are
pre-compiled). JAX's persistent compilation cache removes it across runs:
compiled executables are keyed by (program, flags, platform) and reloaded
from disk.

Enabled by the CLI on startup (app.cli.main). Where the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX reads that directory itself and this
module sets none. Otherwise the cache lives at one fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled = False


def cache_dir() -> Path:
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else DEFAULT_DIR


def enable_persistent_compile_cache() -> Path:
    """Idempotently turn on JAX's persistent compilation cache and return
    the directory in use. Must run before the first jit compile to help
    that compile; safe any time."""
    global _enabled
    path = cache_dir()
    if _enabled:
        return path
    import jax

    if not os.environ.get(ENV_VAR):
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    # cache everything that takes meaningful time; tiny programs stay
    # uncached so the directory doesn't fill with trivia
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return path
