"""Framework-level JAX runtime configuration.

Enables the persistent XLA compilation cache so repeat runs and test
sessions start hot.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps
the cache there and this module sets no other directory; otherwise the
cache is the fixed ``<checkout>/.jax_cache`` (a fixed path, because the
path is part of the cache key).  Importing this module is idempotent.
"""
from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> None:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


enable_compilation_cache()
