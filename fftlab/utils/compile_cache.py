"""JAX's persistent compilation cache, kept at a fixed place.

The cache directory is part of what lets a later process find what an
earlier one compiled, so it never moves: `JAX_COMPILATION_CACHE_DIR`
when the environment sets it (JAX reads that variable itself), otherwise
`<checkout>/.jax_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    Call before the first compilation. With `JAX_COMPILATION_CACHE_DIR`
    set, nothing is changed here."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
