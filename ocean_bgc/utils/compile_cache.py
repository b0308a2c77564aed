"""Where JAX keeps its persistent compilation cache.

The cache's path is part of its key, so it lives at one fixed place:
the directory that ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads that
variable itself), and otherwise ``<checkout>/.jax_cache/``, which
``.gitignore`` lists.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory
    and return that directory.  Call before the first compile."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
