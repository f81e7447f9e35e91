"""Persistent XLA compile cache for the repository's scripts.

Importing the library sets no cache.  ``bench.py`` and ``chip_smoke.py``
call :func:`enable_compile_cache` once, before their first compile:

- with ``JAX_COMPILATION_CACHE_DIR`` set, JAX already caches there, and
  nothing else is set;
- without it, the cache goes to the fixed directory ``<root>/.jax_cache``
  (listed in ``.gitignore``).  The path is part of the cache key, so it is
  never a temporary name, a process id or a time.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root: str) -> str:
    """Turn on the persistent compile cache; return its directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    cache_dir = os.path.join(os.path.abspath(root), ".jax_cache")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
