"""Persistent XLA compilation cache.

Every entry point enables JAX's persistent compilation cache so a second
process reuses the executables the first one compiled.  The directory is
``JAX_COMPILATION_CACHE_DIR`` when that is set; otherwise a fixed
``.jax_cache/`` at the checkout root, so the path — part of the cache key —
never moves.
"""

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_cache() -> None:
    """Enable the persistent compilation cache (call before first jit)."""
    jax.config.update("jax_compilation_cache_dir", cache_dir())
