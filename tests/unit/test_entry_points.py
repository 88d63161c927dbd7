"""The GPU entry points (chip_smoke.py, bench.py) refuse to run without a
GPU, and the persistent compile cache goes where it should."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mixed_precision_multigrid_solvers_for_pdes_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_fixed_dir_in_checkout(monkeypatch, tmp_path,
                                             restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache(str(tmp_path))
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "elsewhere"))
    path = compile_cache.enable_compile_cache(str(tmp_path))
    assert path == str(tmp_path / "elsewhere")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_point_refuses_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
