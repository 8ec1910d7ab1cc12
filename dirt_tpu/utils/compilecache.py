"""Persistent XLA compilation cache (process-spanning).

A cold 1024^2 fwd+bwd step spends tens of seconds compiling, so every
entry point that jits production shapes (bench.py, bench_configs.py,
chip_smoke.py, demos, tools) enables the persistent cache first thing.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX itself
reads it and this module sets no other directory. Otherwise the cache is
``.jax_cache/`` inside the checkout (listed in ``.gitignore``): a fixed
path, because the path is part of what makes a later process hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Idempotently enable the persistent compilation cache.

    Returns the cache directory.
    """
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if ENV_VAR not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
