"""Entry-point set-up: the persistent compilation cache location and the
device description every measurement prints."""

import os

import jax
import pytest

from clsim_tpu.util import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    """Without the variable the cache sits at <checkout>/.jax_cache: a fixed
    path (no temporary name, pid or time), so a later process hits it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert runtime.compile_cache_dir() == path


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_card_query_fails_loudly_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(OSError):
        runtime.card_name_and_power_limit()


def test_device_summary_names_the_platform():
    d = runtime.device_summary()
    assert d == {"platform": jax.devices()[0].platform,
                 "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}
