"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (tests, benchmarks, ``chip_smoke.py``): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no directory; otherwise the cache lives in ``.jax_cache/`` inside the
checkout (listed in ``.gitignore``), a fixed path so entries are found
again from run to run.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Every executable is cached, however quick its compile: the CPU test
    suite compiles hundreds of small programs per process.
    """
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir()
