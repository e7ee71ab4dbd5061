"""Persistent compilation cache location — one rule for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set in code.  Otherwise the cache lives at a fixed path inside the
checkout (``.jax_cache/``, git-ignored): the path is part of the cache
key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None) -> tuple[str, bool]:
    """(cache directory, whether code must set it) under ``environ``
    (default: the process environment)."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV):
        return environ[ENV], False
    return str(DEFAULT_DIR), True


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; call
    before the first compilation.  Returns the directory in use."""
    path, set_in_code = cache_dir()
    if set_in_code:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
