"""Where JAX keeps its persistent compilation cache.

A cold compile of a full-size render takes tens of seconds; the cache makes
the second process that runs the same program start warm. Every entry point
calls `setup_compile_cache()` before its first compile.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    it. Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is changed; otherwise the cache lives in `.jax_cache` at the
    root of the checkout, a fixed path that every later process finds."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
