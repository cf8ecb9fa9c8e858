"""Benchmark plumbing: compile-cache location, timing helper, and the GPU
smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from sift_pyocl_jax.utils import benchtool

REPO = Path(__file__).resolve().parents[1]


def _with_cache_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    old = jax.config.jax_compilation_cache_dir
    try:
        return benchtool.enable_compile_cache(), jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    want = str(tmp_path / "cc")
    got, configured = _with_cache_env(monkeypatch, want)
    assert got == configured == want and os.path.isdir(want)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    got, configured = _with_cache_env(monkeypatch, None)
    assert got == configured == str(REPO / ".jax_compile_cache")


def test_time_ms_and_chained_ms_positive():
    x = jnp.ones((64, 64))
    assert benchtool.chained_ms(lambda a: a @ a, x, n_hi=3, reps=2) > 0
    assert benchtool.time_ms(jax.jit(jnp.sin), x, n=2, reps=1) > 0


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (or no package beside the script): non-zero exit, no result."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = _run(script, script.parent)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
