"""Compile-cache path rule (utils/jaxcache.py) and the GPU smoke script's
refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax

from imageencoder_tpu.utils import jaxcache

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cache_dir_from_env_is_left_to_jax(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(jaxcache.ENV, "/some/where")
    assert jaxcache.configure_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(jaxcache.ENV, raising=False)
    try:
        path = jaxcache.configure_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
