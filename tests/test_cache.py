"""The persistent compilation cache: on only for GPUs, at
JAX_COMPILATION_CACHE_DIR when it is set and at <repo>/.jax_cache
otherwise."""

import os

import jax
import pytest

from libstacker_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_dir_is_the_repo_dir_without_the_variable(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")


def test_gpu_cache_uses_the_variable(monkeypatch, tmp_path,
                                     restore_cache_config):
    """With the variable set the cache goes there and the code sets no
    directory of its own (JAX reads the variable)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_gpu_cache_defaults_to_the_repo(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cache.enable_compilation_cache() == cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == cache.REPO_CACHE_DIR


def test_cache_stays_off_on_cpu(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == ""
    assert jax.config.jax_compilation_cache_dir == before
