"""Persistent compilation cache for every entry point.

When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
else is set here. Otherwise the cache lives at one fixed path inside the
checkout (``<repo>/.jax_cache``, git-ignored), so repeated runs from the
same checkout find what earlier runs compiled.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its one directory; returns it."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
