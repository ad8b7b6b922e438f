"""Where JAX keeps its persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, this module
sets nothing.  When it is unset, the cache goes to one fixed directory in
the checkout, ``<repo>/.jax_cache`` (listed in .gitignore), so that runs from
the same checkout find each other's compiled programs.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
