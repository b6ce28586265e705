"""Persistent XLA compile cache at one fixed place."""

from __future__ import annotations

import os
from pathlib import Path

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is unset: a
#: fixed path inside the checkout (listed in .gitignore)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    JAX_COMPILATION_CACHE_DIR, when set, is used as JAX reads it; no
    other directory is set in code then."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
