"""utils/runtime.py: compile-cache placement and the GPU-only guard."""

import jax
import pytest

from kmer_spans.utils import runtime


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands and the
    helper sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    """Unset: the cache goes to <repo>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == runtime.REPO_CACHE_DIR
        assert got.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    """The tests run on the CPU backend: the measurement guard exits."""
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()
