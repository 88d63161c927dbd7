"""Persistent XLA compilation cache for the entry points.

Large solves take tens of seconds to compile; a persistent cache lets the
next process reuse them. The cache directory is part of every entry's key,
so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root: str) -> str:
    """Turn on the persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``<root>/.jax_cache``, a fixed
    path inside the checkout (listed in .gitignore)."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
