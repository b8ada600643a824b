"""Where JAX keeps its persistent compilation cache.

The cache key includes the cache path, so the path must not move between
runs. ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing is set here. Otherwise the cache lives at ``<checkout>/.jax_cache``
(a subdirectory may be named, e.g. one per host CPU for the test suite).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache(subdir: str = "") -> str:
    """Point JAX's persistent compilation cache at its fixed path, unless
    ``JAX_COMPILATION_CACHE_DIR`` or an earlier call already placed it.
    Returns the directory in use."""
    placed = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
              or jax.config.jax_compilation_cache_dir)
    if placed:
        return placed
    path = os.path.join(CHECKOUT, ".jax_cache", subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
