"""Persistent XLA compilation cache for the entry-point scripts.

A cold run compiles every transform it times; JAX's persistent
compilation cache keyed on HLO makes a re-run on the same machine a warm
start from disk.  The cache lives where ``JAX_COMPILATION_CACHE_DIR``
says when that is set, and otherwise at the fixed ``<repo>/.jax_cache``
(the path is part of the cache key, so a moving directory never hits).

Entry scripts (chip_smoke.py, verify.py) call ``enable()`` explicitly;
the library itself never does — the CPU test suite compiles thousands
of tiny throwaway executables that must not churn the cache.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else <repo>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    cache every executable.  Must run before the first jit compile; safe
    to call more than once.  Returns the cache directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
