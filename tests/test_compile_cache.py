"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
says, and otherwise at the fixed <repo>/.jax_cache."""

from pathlib import Path

from smfft.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_default_dir_is_repo_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert Path(compile_cache.cache_dir()) == REPO / ".jax_cache"


def test_jax_compilation_cache_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_empty_variable_falls_back_to_default(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert Path(compile_cache.cache_dir()) == REPO / ".jax_cache"


def test_old_variable_is_ignored(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("SMFFT_COMPILE_CACHE_DIR", str(tmp_path))
    assert Path(compile_cache.cache_dir()) == REPO / ".jax_cache"
