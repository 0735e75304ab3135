"""Where the persistent compilation cache goes (lqr_tpu.compile_cache)."""

import pathlib

import jax

from lqr_tpu import compile_cache


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == tmp_path
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_beside_the_package(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable()
    pkg = pathlib.Path(compile_cache.__file__).resolve().parent
    assert d == pkg.parent / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(d)
    assert compile_cache.enable() == d          # fixed, not per-call
