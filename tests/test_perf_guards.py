"""Performance guards: the counterpart of the reference's JET type-stability
+ zero-allocation gates (/root/reference/test/clear_sky_utils.jl:88-99).

For a jit-based framework the equivalent invariants are:
- no RETRACING when called again with same-shaped new data (compile once)
- no host synchronization inside the solve (pure device computation)
- dtype stability: f32 inputs produce f32 fluxes (no silent f64 promotion)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from rrtmgp_tpu.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu.models.rrtmgp import solve_lw, solve_sw
from rrtmgp_tpu.states import LwBCs, SwBCs

NBND, NGPT, NCOL, NLAY = 2, 16, 8, 30
LKP_LW = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND)
LKP_SW = synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1)


def _mk(seed):
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, seed=seed)
    bcs_lw = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98))
    bcs_sw = SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.6),
        toa_flux=jnp.full((NCOL,), 1361.0),
        sfc_alb_direct=jnp.full((NBND, NCOL), 0.2),
        sfc_alb_diffuse=jnp.full((NBND, NCOL), 0.2),
    )
    return atm, bcs_lw, bcs_sw


def test_no_retrace_on_new_data():
    """Same shapes/dtypes -> exactly one trace (the reference's JET analogue)."""
    traces = {"n": 0}

    def f(a, b):
        traces["n"] += 1
        return solve_lw(LKP_LW, a, b)[0]

    jf = jax.jit(f)
    a1, b1, _ = _mk(1)
    a2, b2, _ = _mk(2)
    jf(a1, b1)
    jf(a2, b2)
    jf(a1, b1)
    assert traces["n"] == 1, f"solve_lw retraced {traces['n']} times"


def test_dtype_stability_f32():
    """f32 state in -> f32 fluxes out, f64 lookup tables notwithstanding."""
    atm32 = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32)
    lkp32 = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=np.float32)
    bcs = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98, jnp.float32))
    flux, _ = jax.jit(lambda a, b: solve_lw(lkp32, a, b))(atm32, bcs)
    assert flux.flux_up.dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(flux.flux_up)))


def test_f32_vs_f64_flux_agreement():
    """f32 fluxes track f64 within the reference's f32 tolerance envelope
    (0.05 W/m^2 scale, /root/reference/test/runtests.jl:21-23)."""
    atm64, bcs64, bcssw64 = _mk(3)
    atm32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
        atm64,
    )
    lkp32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
        LKP_LW,
    )
    f64, _ = jax.jit(lambda a, b: solve_lw(LKP_LW, a, b))(atm64, bcs64)
    bcs32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), bcs64)
    f32, _ = jax.jit(lambda a, b: solve_lw(lkp32, a, b))(atm32, bcs32)
    d = np.abs(np.asarray(f64.flux_up) - np.asarray(f32.flux_up, np.float64))
    assert d.max() < 0.1, f"f32 deviates {d.max()} W/m^2 from f64"


def test_no_nans_with_debug_nans_style_sweep():
    """Extreme-but-legal states stay finite (cos-zenith edge cases analogue,
    /root/reference/test/cos_zenith_edge_cases.jl)."""
    atm, bcs_lw, bcs_sw = _mk(4)
    # extreme temperatures and tiny vmr
    atm = dataclasses.replace(
        atm,
        t_lay=jnp.clip(atm.t_lay * 1.3, 160.0, 355.0),
        t_lev=jnp.clip(atm.t_lev * 0.7, 160.0, 355.0),
    )
    flux, _ = jax.jit(lambda a, b: solve_lw(LKP_LW, a, b, two_stream=True))(atm, bcs_lw)
    assert bool(jnp.all(jnp.isfinite(flux.flux_up)))
    fsw, _ = jax.jit(lambda a, b: solve_sw(LKP_SW, a, b))(
        atm, dataclasses.replace(bcs_sw, cos_zenith=jnp.full((NCOL,), 1e-7))
    )
    assert bool(jnp.all(jnp.isfinite(fsw.flux_up)))
