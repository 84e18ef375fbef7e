"""The harness around the solve: compile-cache placement, device
identification, the benchmarks' refusal to run without a GPU, and their
chunk arithmetic."""

import os
import subprocess
import sys

import jax
import pytest

from rrtmgp_tpu.utils import compile as cc
from rrtmgp_tpu.utils.device import NoGPUError, device_info, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_cache_dir_follows_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.compile_cache_dir() == str(tmp_path)
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cc.enable_compile_cache(2.0)
    assert path == cc.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
    # the same on every call: nothing temp-, pid- or time-derived
    assert cc.enable_compile_cache() == path


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_info_names_the_backend():
    info = device_info()
    assert set(info) == {"platform", "kind", "count"}
    assert info["platform"] == jax.devices()[0].platform
    assert info["count"] == len(jax.devices())


def test_require_gpu_refuses_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(NoGPUError, match="no CPU fallback"):
        require_gpu()


@pytest.mark.parametrize("script", ["bench.py", "benchmarks/dyamond.py"])
def test_benchmarks_refuse_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_NCOL="8")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert "columns/s" not in r.stdout


@pytest.mark.parametrize(
    "ncol, target, want",
    [(90650, 32768, 30217), (75748, 32768, 25250), (32768, 32768, 32768), (10, 4, 4)],
)
def test_dyamond_pick_chunk(ncol, target, want):
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from dyamond import pick_chunk

    chunk = pick_chunk(ncol, target)
    assert chunk == want
    assert chunk <= target and -(-ncol // chunk) * chunk - ncol < -(-ncol // target)
