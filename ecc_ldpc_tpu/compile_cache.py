"""JAX's persistent compilation cache, kept in one fixed place.

Compiling the layered decoders of the long codes takes long enough that
every entry point (the CLI, bench.py, chip_smoke.py, the experiments)
keeps compiled programs across processes. A cache only hits when it is
found again at the same path, so the path is fixed: JAX_COMPILATION_CACHE_DIR
when the environment sets it (JAX reads that variable itself, so nothing is
changed here), otherwise `.jax_cache` at the root of the checkout, which
.gitignore lists.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory.

    Call before the first compilation: JAX decides whether a process uses
    the cache when it compiles for the first time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
