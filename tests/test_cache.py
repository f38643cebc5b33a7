"""The persistent compilation cache lives at one place for every entry
point: JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""

import pathlib

import jax
import pytest

from pedoni_tpu.utils import cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


def test_default_is_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = cache.enable_compile_cache()
    root = pathlib.Path(__file__).resolve().parents[1]
    assert d == str(root / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
