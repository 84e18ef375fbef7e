"""DYAMOND-scale benchmark harness.

Mirrors the reference's GPU benchmark scripts
(/root/reference/test/clear_sky_dyamond_gpu_benchmark.jl:102-124 and
 test/{cloudy,all}_sky*_dyamond_gpu_benchmark.jl): clear-sky at
ncol = ceil(30*30*6*4^2*64/61) = 90,650 columns and all-sky at
ncol = ceil(86,400*64/73) = 75,748 columns, 60 layers, full spectral size,
reporting median solve times and columns/s. Memory is bounded by sequential
column chunks (models.rrtmgp.solve_chunked); the default is one chunk per
DEFAULT_CHUNK columns. Needs a GPU: without one the script fails.

Usage: python benchmarks/dyamond.py [clear|allsky|aerosky] [--ncol N] [--chunk N]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

CLEAR_NCOL = 90650   # ref clear_sky_dyamond_gpu_benchmark.jl:102
ALLSKY_NCOL = 75748  # ref all_sky_with_aerosols_dyamond_gpu_benchmark.jl:114
#: default column chunk: the bench size, whose unchunked f32 clear pair
#: needs 2.03e10 B of temporaries (memory_analysis on an NVIDIA H100 80GB
#: HBM3 at a 400 W power limit, of a 6.4e10 B device limit)
DEFAULT_CHUNK = 32768


def pick_chunk(ncol: int, target: int) -> int:
    """Chunk <= target that minimizes column padding: ceil(ncol / n_chunks)."""
    n_chunks = -(-ncol // target)
    return -(-ncol // n_chunks)


def run(mode: str, ncol: int, chunk: int, nlay: int = 60, n_iters: int = 10,
        lw_two_stream: bool = True):
    import jax
    import jax.numpy as jnp

    from rrtmgp_tpu.utils.compile import enable_compile_cache
    from rrtmgp_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    print(require_gpu(), gpu_name_and_power_limit(), flush=True)
    enable_compile_cache()

    from rrtmgp_tpu.data.synthetic import (
        synthetic_aerosol_lookup,
        synthetic_atmosphere,
        synthetic_cloud_lookup,
        synthetic_gas_lookup,
    )
    from rrtmgp_tpu.models.rrtmgp import solve_chunked, solve_lw, solve_sw
    from rrtmgp_tpu.states import LwBCs, SwBCs

    dtype = np.float32
    ncol_pad = -(-ncol // chunk) * chunk
    print(f"mode={mode} ncol={ncol} (padded {ncol_pad}) chunk={chunk} nlay={nlay}")

    lkp_lw = synthetic_gas_lookup(longwave=True, n_gpt=256, n_bnd=16, dtype=dtype)
    lkp_sw = synthetic_gas_lookup(longwave=False, n_gpt=224, n_bnd=14, seed=1, dtype=dtype)
    atm = synthetic_atmosphere(
        ncol=ncol_pad, nlay=nlay, dtype=dtype, with_clouds=(mode != "clear"),
        with_aerosols=(mode == "aerosky"),
    )
    bcs_lw = LwBCs(sfc_emis=jnp.full((16, ncol_pad), 0.98, jnp.float32))
    bcs_sw = SwBCs(
        cos_zenith=jnp.full((ncol_pad,), 0.6, jnp.float32),
        toa_flux=jnp.full((ncol_pad,), 1361.0, jnp.float32),
        sfc_alb_direct=jnp.full((14, ncol_pad), 0.2, jnp.float32),
        sfc_alb_diffuse=jnp.full((14, ncol_pad), 0.2, jnp.float32),
    )

    lkp_cld_lw = lkp_cld_sw = lkp_aero_lw = lkp_aero_sw = None
    if mode != "clear":
        lkp_cld_lw = synthetic_cloud_lookup(n_bnd=16, dtype=dtype)
        lkp_cld_sw = synthetic_cloud_lookup(n_bnd=14, seed=5, dtype=dtype)
    aero_species = None
    if mode == "aerosky":
        # all-sky WITH aerosols: the reference's headline all-sky workload
        # (ref test/all_sky_with_aerosols_dyamond_gpu_benchmark.jl)
        lkp_aero_lw = synthetic_aerosol_lookup(n_bnd=16, dtype=dtype)
        lkp_aero_sw = synthetic_aerosol_lookup(n_bnd=14, seed=9, dtype=dtype)
        # static active-species set, inspected once at init (hosts know
        # which MERRA species they load)
        m = np.asarray(atm.aerosol_state.aero_mass)
        aero_species = tuple(int(i) for i in np.nonzero(m.any(axis=(1, 2)))[0])
        print(f"active aerosol species: {aero_species}")

    if mode == "clear":

        @jax.jit
        def f_lw(a, b):
            return solve_chunked(
                lambda ac, bc: solve_lw(lkp_lw, ac, bc)[0],
                a, b, chunk,
            )

        @jax.jit
        def f_sw(a, b):
            return solve_chunked(
                lambda ac, bc: solve_sw(lkp_sw, ac, bc)[0],
                a, b, chunk,
            )

        args_lw = (atm, bcs_lw)
        args_sw = (atm, bcs_sw)
    else:
        # McICA mask sampling runs INSIDE the timed solve — the reference
        # samples per column inside its timed solves
        # (ref src/rte/longwave1scalar.jl:72, cloud_optics.jl:222-261).

        @jax.jit
        def f_lw(a, b, seed):
            return solve_chunked(
                lambda ac, bc, sc, off: solve_lw(
                    lkp_lw, ac, bc, two_stream=lw_two_stream,
                    lkp_cld=lkp_cld_lw,
                    lkp_aero=lkp_aero_lw, cld_mask_seed=sc, col_offset=off,
                    aero_species=aero_species,
                )[0],
                a, b, chunk, cld_mask_seed=seed,
            )

        @jax.jit
        def f_sw(a, b, seed):
            return solve_chunked(
                lambda ac, bc, sc, off: solve_sw(
                    lkp_sw, ac, bc, lkp_cld=lkp_cld_sw, lkp_aero=lkp_aero_sw,
                    cld_mask_seed=sc, col_offset=off, aero_species=aero_species,
                )[0],
                a, b, chunk, cld_mask_seed=seed,
            )

        args_lw = (atm, bcs_lw, jnp.asarray(0, jnp.int32))
        args_sw = (atm, bcs_sw, jnp.asarray(1, jnp.int32))

    for name, f, args in (("LW", f_lw, args_lw), ("SW", f_sw, args_sw)):
        t0 = time.perf_counter()
        r = jax.block_until_ready(f(*args))
        print(f"{name} compile+run: {time.perf_counter()-t0:.1f}s", flush=True)
        times = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            r = jax.block_until_ready(f(*args))
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        # a benchmark of NaNs is not a benchmark; make that loud
        peek = float(np.asarray(r.flux_up[0, 0]))
        assert np.isfinite(peek), f"{name}: non-finite fluxes"
        print(
            f"{name} solve: median {med*1e3:.1f} ms -> {ncol/med:,.0f} columns/s",
            flush=True,
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "mode", nargs="?", default="clear", choices=["clear", "allsky", "aerosky"]
    )
    ap.add_argument("--ncol", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument(
        "--lw-noscat", action="store_true",
        help="all-sky LW with the no-scat solver (ref cloudy tests run both "
        "LW solvers)",
    )
    a = ap.parse_args()
    ncol = a.ncol or (CLEAR_NCOL if a.mode == "clear" else ALLSKY_NCOL)
    chunk = a.chunk or pick_chunk(ncol, DEFAULT_CHUNK)
    from rrtmgp_tpu.utils.device import NoGPUError

    try:
        run(a.mode, ncol, chunk, n_iters=a.iters, lw_two_stream=not a.lw_noscat)
    except NoGPUError as e:
        sys.exit(f"dyamond.py: {e}")
