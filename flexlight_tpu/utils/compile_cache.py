"""Persistent XLA compilation cache.

The 1080p full pipeline compiles for tens of seconds per shape; the cache
makes that once per machine. Where `JAX_COMPILATION_CACHE_DIR` is set,
JAX reads it itself and this module sets no other directory. Otherwise
the cache lives at a fixed `<repo>/.jax_cache` (listed in .gitignore): the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_DIR, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else DEFAULT_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
