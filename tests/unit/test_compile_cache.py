"""compile_cache.enable_compile_cache: JAX_COMPILATION_CACHE_DIR when the
environment sets it (and then nothing else changes), otherwise the
checkout's .jax_cache. Run in subprocesses, since the setting is global."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PROBE = """
import jax, jax.numpy as jnp
from ecc_ldpc_tpu.compile_cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)


def cache_probe(x):
    return jnp.cos(x) * 3


jax.jit(cache_probe)(jnp.ones(16)).block_until_ready()
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def _entries(cache):
    """Cache entries of the probe's function, named after it."""
    return set(cache.glob("jit_cache_probe-*")) if cache.exists() else set()


def test_env_dir_is_used_and_filled(tmp_path):
    cache = tmp_path / "cache"
    returned, configured = _probe(cache)
    assert returned == configured == str(cache)
    assert _entries(cache)


def test_default_is_checkout_dot_jax_cache():
    cache = ROOT / ".jax_cache"
    for p in _entries(cache):  # only this test writes entries of that name
        p.unlink()
    existed = cache.exists()
    before = set(cache.iterdir()) if existed else set()
    returned, configured = _probe(None)
    try:
        assert returned == configured == str(cache)
        assert _entries(cache), "no entry landed in the checkout's .jax_cache"
    finally:  # leave the checkout's cache as the test found it
        for p in set(cache.iterdir()) - before:
            if p.is_file():
                p.unlink()
        if not existed and not any(cache.iterdir()):
            cache.rmdir()
