"""Where the persistent XLA compilation cache lives.

Compiling the step takes seconds to minutes, so every entry point (tests,
benchmark, demo, chip smoke run) shares one on-disk cache. The cache key
includes its directory, so the directory is fixed: `JAX_COMPILATION_CACHE_DIR`
when the environment sets it, otherwise `.jax_cache` at the root of this
checkout (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The cache directory the entry points use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` (programs
    that compile in under a second are not cached). Returns the path."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
