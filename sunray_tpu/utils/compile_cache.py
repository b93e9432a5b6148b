"""JAX persistent compilation cache at a fixed place.

A cold 1080p frame program takes tens of seconds to compile; the cache
turns the second process's compile into a load. The cache key includes
the directory, so the path must not move between runs: with
`JAX_COMPILATION_CACHE_DIR` set, JAX already reads it and nothing else is
configured; otherwise the cache lives at `<checkout>/.jax_cache`.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses (env var, else default)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`.
    Idempotent; returns the directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR) and jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
