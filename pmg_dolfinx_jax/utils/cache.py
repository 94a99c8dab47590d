"""The one place that configures JAX's persistent compilation cache.

Every entry point (tests, example drivers, bench.py, chip_smoke.py,
tools) calls `enable_compile_cache` before its first compile. When the
environment sets ``JAX_COMPILATION_CACHE_DIR``, JAX already reads it and
this helper sets nothing else; otherwise the cache lives in
``<repo>/.jax_cache`` (git-ignored), a fixed path so that repeat runs
from one checkout hit it.
"""

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_secs=0.5):
    """Point JAX's persistent compilation cache at its one location and
    return that directory. Only programs that took at least
    ``min_compile_secs`` to compile are written (when the repo default
    is used)."""
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return REPO_CACHE
