"""The persistent XLA compilation cache, at one place per checkout.

JAX keys its cache on the compiled program, so a cache directory that
stays put across runs turns a cold compile of the engine steps into a
disk read."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``.jax_cache`` at the root of the checkout that holds this package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache goes to
    ``default_cache_dir()``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
