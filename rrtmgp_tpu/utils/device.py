"""Which device a measurement ran on.

Every benchmark and smoke result names its device. A measurement path that
finds no GPU fails: it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX's default device is not a GPU."""


def device_info() -> dict:
    """{"platform", "kind", "count"} of jax.devices(), as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or NoGPUError unless JAX's first device is a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise NoGPUError(
            f"needs an NVIDIA GPU, but JAX's default device is {info['platform']!r} "
            f"({info['kind']}); no CPU fallback"
        )
    return info


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card, one per line.

    Runs in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
