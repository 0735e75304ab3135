"""Where JAX keeps its persistent compilation cache for this program.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing here changes it. Otherwise the cache lives in ``.jax_cache`` beside
the package, a fixed path (the path is part of the cache key, so a directory
that moved between runs would never hit).
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> pathlib.Path:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return pathlib.Path(env)
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
