"""Benchmark harness: prints ONE JSON line.

Metric: clear-sky columns/s on one GPU at real spectral size (LW no-scat
256 g-pt + SW two-stream 224 g-pt, 60 layers, f32) — the reference's
DYAMOND-style headline workload
(/root/reference/test/clear_sky_dyamond_gpu_benchmark.jl). Synthetic lookup
tables with real dimensions are used when rrtmgp-data artifacts are absent;
the compute/memory profile is identical to real-data runs.

Timing is the median of BENCH_REPS (default 5) independent reps of
BENCH_ITERS solves each, every rep closed by block_until_ready; the spread
field is (max-min)/median across reps. The result names the device JAX ran
on and the card's name and power limit. Without a GPU the script fails.

Usage: python bench.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

NCOL = int(os.environ.get("BENCH_NCOL", "32768"))
NLAY = 60
REPS = int(os.environ.get("BENCH_REPS", "5"))
ITERS = int(os.environ.get("BENCH_ITERS", "10"))


def measure() -> dict:
    import jax
    import jax.numpy as jnp

    from rrtmgp_tpu.utils.compile import enable_compile_cache
    from rrtmgp_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    info = require_gpu()
    enable_compile_cache()

    from rrtmgp_tpu.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
    from rrtmgp_tpu.models.rrtmgp import solve_lw, solve_sw
    from rrtmgp_tpu.states import LwBCs, SwBCs

    dtype = np.float32
    lkp_lw = synthetic_gas_lookup(longwave=True, n_gpt=256, n_bnd=16, dtype=dtype)
    lkp_sw = synthetic_gas_lookup(longwave=False, n_gpt=224, n_bnd=14, seed=1, dtype=dtype)
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=dtype)
    bcs_lw = LwBCs(sfc_emis=jnp.full((16, NCOL), 0.98, jnp.float32))
    bcs_sw = SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.6, jnp.float32),
        toa_flux=jnp.full((NCOL,), 1361.0, jnp.float32),
        sfc_alb_direct=jnp.full((14, NCOL), 0.2, jnp.float32),
        sfc_alb_diffuse=jnp.full((14, NCOL), 0.2, jnp.float32),
    )

    # ONE jitted program per radiation step (LW + SW), matching the solver's
    # update_fluxes() production path
    f_pair = jax.jit(
        lambda a, bl, bs: (solve_lw(lkp_lw, a, bl)[0], solve_sw(lkp_sw, a, bs)[0])
    )

    # compile, then one full untimed rep
    jax.block_until_ready(f_pair(atm, bcs_lw, bcs_sw))
    for _ in range(ITERS):
        out = f_pair(atm, bcs_lw, bcs_sw)
    jax.block_until_ready(out)

    per_rep = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = f_pair(atm, bcs_lw, bcs_sw)
        jax.block_until_ready(out)
        per_rep.append((time.perf_counter() - t0) / ITERS)

    dt = statistics.median(per_rep)  # one LW + one SW solve
    return {
        "metric": "clear-sky columns/s (LW noscat 256gpt + SW 2stream 224gpt, 60 layers, f32)",
        "value": NCOL / dt,
        "unit": "columns/s",
        "ncol": NCOL,
        "reps": REPS,
        "iters_per_rep": ITERS,
        "spread": (max(per_rep) - min(per_rep)) / dt,
        "rep_ms": [1e3 * t for t in per_rep],
        "device": info,
        "gpu": gpu_name_and_power_limit(),
    }


def main() -> None:
    from rrtmgp_tpu.utils.device import NoGPUError

    try:
        result = measure()
    except NoGPUError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
