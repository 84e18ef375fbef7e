"""Test configuration.

Tests run on the CPU backend unless JAX_PLATFORMS says otherwise (the
``gpu``-marked tests need ``JAX_PLATFORMS=cuda,cpu``; see README). Float64
is enabled because the reference's correctness oracles are defined for both
f32 and f64 (/root/reference/test/runtests.jl:21-30).
"""

import os

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
# NOTE: do NOT force a multi-device CPU here — 8 virtual devices makes XLA-CPU
# compiles ~10x slower. Multi-device tests spawn subprocesses with
# --xla_force_host_platform_device_count themselves.

import jax
import pytest

from rrtmgp_tpu.utils.compile import enable_compile_cache

jax.config.update("jax_enable_x64", True)
enable_compile_cache(0.5)


@pytest.fixture
def gpu_device():
    """The first GPU JAX finds; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run with JAX_PLATFORMS=cuda,cpu on a GPU host)")
