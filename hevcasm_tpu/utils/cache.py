"""Persistent XLA compilation cache.

The encode programs are compile-heavy (the closed-loop GOP and the PU
decision unroll many stages) while their compiled executables are stable
across runs.  JAX's persistent cache keys compiled executables on (HLO,
compiler version, device) and lets every run after the first load them
from disk — the shape of the reference's ahead-of-time build (its kernels
compile once at `make`).

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, so nothing is configured in code); otherwise a
fixed ``.jax_cache`` directory at the root of the checkout, so the path —
part of the cache key — never moves between runs.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses (see the module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Enable the on-disk compilation cache (idempotent); returns its
    directory.  Entries taking >= 2 s to compile are persisted."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return cache_dir()
