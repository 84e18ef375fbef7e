"""Differentiability of the XLA solve path.

The reference (CliMA/RRTMGP.jl) has no adjoint/AD capability; this framework
gets reverse-mode AD for free on its one (pure-jnp) path because
every solve is a pure function of pytree inputs (SURVEY.md section 7 design
stance: "arrays, not mutable structs"). These tests pin that capability:

- grads exist, are finite, and are non-trivially dense in the vertical;
- a directional derivative matches central finite differences (f64);
- both LW (no-scat + two-stream) and SW (two-stream, incl. the night-column
  zeroing at cos_zenith <= 0) paths differentiate.

The FD probes evaluate at jittered temperatures: the synthetic atmosphere's
values land exactly on the Planck table's 1 K grid knots, where the
piecewise-linear interpolant has a kink — central differences there measure
the average of the two one-sided slopes, not the AD (right-sided) slope.
The AD itself was cross-validated three ways while writing these tests
(composite grad == cotangent . jvp == cotangent . elementwise-FD-jvp).

``jax.grad`` of solve_lw/solve_sw is the gradient; a cloudy gradient takes an
explicit ``cld_mask`` (a sampled mask is not a differentiable input).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrtmgp_tpu.data.synthetic import (
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu.models.rrtmgp import solve_lw, solve_sw
from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica
from rrtmgp_tpu.states import LwBCs, SwBCs

NBND = 2
NGPT = 16
NCOL = 8
NLAY = 16

LKP_LW64 = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=np.float64)
LKP_SW64 = synthetic_gas_lookup(
    longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, dtype=np.float64
)
LKP_CLD64 = synthetic_cloud_lookup(n_bnd=NBND, dtype=np.float64)
ATM64 = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, dtype=np.float64)
BCS_LW64 = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98, jnp.float64))
BCS_SW64 = SwBCs(
    # one night column exercises the cos_zenith <= 0 zeroing under AD
    cos_zenith=jnp.asarray([0.6] * (NCOL - 1) + [-0.1], jnp.float64),
    toa_flux=jnp.full((NCOL,), 1361.0, jnp.float64),
    sfc_alb_direct=jnp.full((NBND, NCOL), 0.2, jnp.float64),
    sfc_alb_diffuse=jnp.full((NBND, NCOL), 0.2, jnp.float64),
)


def _olr_lw(t_lay, *, two_stream):
    atm = dataclasses.replace(ATM64, t_lay=t_lay)
    flux, _ = solve_lw(LKP_LW64, atm, BCS_LW64, two_stream=two_stream)
    return jnp.sum(flux.flux_up[-1])  # outgoing longwave at TOA


def _asr_sw(t_lay):
    # SW gas optics depend on t_lay through the interpolation fractions
    atm = dataclasses.replace(ATM64, t_lay=t_lay)
    flux, _ = solve_sw(LKP_SW64, atm, BCS_SW64)
    return jnp.sum(flux.flux_dn[0] - flux.flux_up[0])  # absorbed at surface


G_LW_NOSCAT = jax.jit(jax.grad(functools.partial(_olr_lw, two_stream=False)))
G_LW_2STR = jax.jit(jax.grad(functools.partial(_olr_lw, two_stream=True)))
V_LW_NOSCAT = jax.jit(functools.partial(_olr_lw, two_stream=False))
G_SW = jax.jit(jax.grad(_asr_sw))
V_SW = jax.jit(_asr_sw)


@pytest.mark.parametrize("gfn", [G_LW_NOSCAT, G_LW_2STR], ids=["noscat", "2stream"])
def test_lw_grad_finite_and_dense(gfn):
    g = np.asarray(gfn(ATM64.t_lay))
    assert g.shape == (NLAY, NCOL)
    assert np.all(np.isfinite(g))
    # warming any layer must change OLR: every (layer, col) entry participates
    # (no sign assertion: the synthetic k-table couples tau to temperature
    # arbitrarily, so warming does not monotonically raise OLR here)
    assert np.count_nonzero(g) == g.size


def _off_knot(t_lay, key):
    """Per-element jitter pushing every interpolation location off its grid
    knot (Planck 1 K grid, k-table t_ref, minor-gas grids): with eps=1e-6 the
    FD window then almost surely contains no kink (module docstring)."""
    return t_lay + 0.1 + 0.8 * jax.random.uniform(key, t_lay.shape, jnp.float64)


def test_lw_grad_matches_finite_differences():
    t0 = _off_knot(ATM64.t_lay, jax.random.key(42))
    direction = jax.random.normal(jax.random.key(7), t0.shape, jnp.float64)
    g = G_LW_NOSCAT(t0)
    analytic = float(jnp.vdot(g, direction))
    # eps balances kink avoidance (jitter >> eps*|direction|) against central-
    # difference cancellation noise on the ~1e4-magnitude objective
    eps = 1e-4
    fd = float(
        (V_LW_NOSCAT(t0 + eps * direction) - V_LW_NOSCAT(t0 - eps * direction))
        / (2 * eps)
    )
    assert abs(analytic - fd) <= 1e-3 * max(1.0, abs(fd))


def test_sw_grad_finite_and_night_column_zero():
    g = np.asarray(G_SW(ATM64.t_lay))
    assert np.all(np.isfinite(g))
    # night column: fluxes are exactly zero regardless of state -> zero grad
    assert np.all(g[:, -1] == 0.0)
    # day columns: temperature affects optics -> non-zero somewhere
    assert np.any(g[:, :-1] != 0.0)


def test_sw_grad_matches_finite_differences():
    t0 = _off_knot(ATM64.t_lay, jax.random.key(43))
    direction = jax.random.normal(jax.random.key(11), t0.shape, jnp.float64)
    analytic = float(jnp.vdot(G_SW(t0), direction))
    eps = 1e-4
    fd = float(
        (V_SW(t0 + eps * direction) - V_SW(t0 - eps * direction)) / (2 * eps)
    )
    assert abs(analytic - fd) <= 1e-3 * max(1.0, abs(fd))


def test_allsky_grad_through_cloud_optics():
    """Grad w.r.t. cloud liquid water path through McICA + cloud LUT interp."""
    mask = build_cloud_mask_mcica(
        jax.random.key(3), ATM64.cloud_state.cld_frac, NGPT
    )

    def olr(lwp):
        cld = dataclasses.replace(ATM64.cloud_state, cld_path_liq=lwp)
        atm = dataclasses.replace(ATM64, cloud_state=cld)
        flux, _ = solve_lw(
            LKP_LW64, atm, BCS_LW64, two_stream=True, lkp_cld=LKP_CLD64,
            cld_mask=mask,
        )
        return jnp.sum(flux.flux_up[-1])

    g = np.asarray(jax.jit(jax.grad(olr))(ATM64.cloud_state.cld_path_liq))
    assert np.all(np.isfinite(g))
    # thicker clouds trap longwave -> OLR decreases where clouds exist
    assert np.any(g != 0.0)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        tree,
    )


@pytest.mark.parametrize("case", ["lw_noscat", "lw_2stream", "sw"])
def test_f32_grad_matches_f64(case):
    """jax.grad of solve_lw/solve_sw is the gradient on every dtype: the f32
    gradient of the same problem agrees with the f64 one to f32 roundoff."""
    lkp64 = LKP_SW64 if case == "sw" else LKP_LW64
    bcs64 = BCS_SW64 if case == "sw" else BCS_LW64

    def total(t_lay, atm, bcs, lkp):
        atm = dataclasses.replace(atm, t_lay=t_lay)
        if case == "sw":
            return jnp.sum(solve_sw(lkp, atm, bcs)[0].flux_dn)
        flux, _ = solve_lw(lkp, atm, bcs, two_stream=case == "lw_2stream")
        return jnp.sum(flux.flux_up + flux.flux_dn)

    g = jax.jit(jax.grad(total))
    t0 = _off_knot(ATM64.t_lay, jax.random.key(5))
    g64 = np.asarray(g(t0, ATM64, bcs64, lkp64))
    args32 = _cast((t0, ATM64, bcs64, lkp64), jnp.float32)
    g32 = np.asarray(g(*args32))
    assert g32.dtype == np.float32
    scale = np.max(np.abs(g64))
    assert scale > 0.0
    # f32 roundoff of a reverse sweep, relative to the largest sensitivity
    # (measured up to 5.5e-3 at this size)
    assert np.max(np.abs(g32 - g64)) <= 1e-2 * scale


def test_lw_grad_wrt_surface_emissivity():
    """Gradients flow to the boundary conditions too: OLR rises with surface
    emissivity in the band whose surface emission reaches TOA (the other
    synthetic band is opaque: its sensitivity is ~0)."""
    def olr(emis):
        flux, _ = solve_lw(LKP_LW64, ATM64, LwBCs(sfc_emis=emis))
        return jnp.sum(flux.flux_up[-1])

    g = np.asarray(jax.jit(jax.grad(olr))(BCS_LW64.sfc_emis))
    assert g.shape == (NBND, NCOL)
    assert np.all(np.isfinite(g))
    assert np.all(g[1] > 1.0) and np.all(np.abs(g[0]) < 1e-6)


def test_sw_grad_through_cloud_optics():
    """SW gradient w.r.t. cloud liquid water path through an explicit McICA
    mask and the delta-scaled cloud optics: non-zero exactly where the mask
    puts cloud (the synthetic state holds liquid cloud only), zero in the
    night column."""
    lkp_cld = synthetic_cloud_lookup(n_bnd=NBND, seed=5, dtype=np.float64)
    mask = build_cloud_mask_mcica(jax.random.key(4), ATM64.cloud_state.cld_frac, NGPT)

    def absorbed(lwp):
        atm = dataclasses.replace(
            ATM64, cloud_state=dataclasses.replace(ATM64.cloud_state, cld_path_liq=lwp)
        )
        flux, _ = solve_sw(LKP_SW64, atm, BCS_SW64, lkp_cld=lkp_cld, cld_mask=mask)
        return jnp.sum(flux.flux_dn[0] - flux.flux_up[0])

    g = np.asarray(jax.jit(jax.grad(absorbed))(ATM64.cloud_state.cld_path_liq))
    assert np.all(np.isfinite(g))
    cloudy = np.any(np.asarray(mask), axis=-1)
    cloudy[:, -1] = False
    assert np.any(g[cloudy] != 0.0)
    assert np.all(g[~np.any(np.asarray(mask), axis=-1)] == 0.0)
    assert np.all(g[:, -1] == 0.0)  # night column
