"""Persistent XLA compilation cache helper.

Applications opt in with one call (the example CLI, bench.py and
chip_smoke.py do) — the library never mutates global JAX config on
import.  The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when
it is set (JAX reads that variable itself), and otherwise at the fixed
``<repo>/.jax_cache``: the path is part of the cache key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache on a GPU.  Safe to call
    more than once; returns the directory, or "" when the cache stays
    off.

    GPU only: serialising some CPU-backend executables crashed inside
    ``jax.compilation_cache.put_executable_and_time`` under pytest, and
    CPU programs compile in seconds anyway."""
    import jax

    if jax.default_backend() != "gpu":
        return ""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache even fast-compiling programs: a pipeline is dozens of small
    # jits whose sub-second compiles add up
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return cache_dir()
