"""Where the program keeps what it builds and caches: inside the checkout
that holds the package, at fixed paths that .gitignore lists."""
from __future__ import annotations

import os

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_DIR, "build")        # native + CUDA libraries
JAX_CACHE_DIR = os.path.join(REPO_DIR, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here; otherwise the cache is JAX_CACHE_DIR."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.config.jax_compilation_cache_dir
