"""JAX's persistent compilation cache, kept at one fixed place.

One rule for every caller (tests, benchmarks, chip_smoke.py): where
``$JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and nothing
here names another path; otherwise it lives in ``<checkout>/.jax_cache``
(listed in .gitignore). The directory is fixed so that a later process finds
what an earlier one compiled.
"""

from __future__ import annotations

import os

#: the cache directory used when $JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR if set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    (idempotent) and return that directory. Call before the first compile."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    return path
