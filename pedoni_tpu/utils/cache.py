"""JAX's persistent compilation cache, set up once for every entry point.

The cache key includes the directory, so it lives at one fixed place:
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself and
nothing is set here), otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
