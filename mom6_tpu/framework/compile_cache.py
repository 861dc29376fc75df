"""Where JAX keeps its persistent compilation cache.

A cache hit needs the same directory every time, so the path is fixed:
``JAX_COMPILATION_CACHE_DIR`` when the caller sets it (JAX reads the
variable itself, and nothing here overrides it), otherwise ``.jax_cache``
at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
