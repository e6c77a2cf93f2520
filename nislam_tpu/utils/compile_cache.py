"""Placement of JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is honored by JAX itself and this
module sets nothing.  Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``): a fixed path, because the
path is part of the cache key.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
