"""The one solve path (batched jnp under XLA) across its scenarios.

Each scenario runs solve_lw/solve_sw in f32 and in f64 from the same inputs
(the f32 problem is the f64 one rounded), so the f32 run is checked against
an exact-precision reference; shapes, McICA keying, chunking, multi-angle
quadrature and metric scaling are checked on the same small problems.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrtmgp_tpu.data.synthetic import (
    synthetic_aerosol_lookup,
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu.models.rrtmgp import solve_chunked, solve_lw, solve_sw
from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica
from rrtmgp_tpu.states import LwBCs, SwBCs, tree_map_columns

NCOL, NLAY, NGPT, NBND = 8, 12, 16, 2
LKP = {
    "lw": synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND),
    "sw": synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1),
}
CLD = {"lw": synthetic_cloud_lookup(n_bnd=NBND), "sw": synthetic_cloud_lookup(n_bnd=NBND, seed=5)}
AERO = {
    "lw": synthetic_aerosol_lookup(n_bnd=NBND),
    "sw": synthetic_aerosol_lookup(n_bnd=NBND, seed=6),
}
#: f32-vs-f64 flux tolerance at this width: f32 roundoff of 16 g-points x 12
#: layers at ~1e2-1e3 W/m^2
ATOL = 2e-2


def _cast(tree, dtype):
    def leaf(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, dtype)
        return x

    return jax.tree_util.tree_map(leaf, tree)


def _atm(ncol=NCOL, nlay=NLAY, cloud_frac=0.6):
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, with_clouds=True, with_aerosols=True,
                               p_top=100.0)
    cs = atm.cloud_state
    return dataclasses.replace(
        atm, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * cloud_frac)
    )


def _bcs(wave, ncol=NCOL, inc=False):
    if wave == "lw":
        return LwBCs(
            sfc_emis=jnp.full((NBND, ncol), 0.98),
            inc_flux=jnp.full((ncol, NGPT), 0.3) if inc else None,
        )
    return SwBCs(
        cos_zenith=jnp.asarray(np.linspace(-0.2, 1.0, ncol)),
        toa_flux=jnp.full((ncol,), 1361.0),
        sfc_alb_direct=jnp.full((NBND, ncol), 0.2),
        sfc_alb_diffuse=jnp.full((NBND, ncol), 0.25),
        inc_flux_diffuse=jnp.full((ncol, NGPT), 0.4) if inc else None,
    )


def _solve(wave, atm, bcs, dtype, **kw):
    fn = solve_lw if wave == "lw" else solve_sw
    lkp = _cast(LKP[wave], dtype)
    kw = {k: _cast(v, dtype) for k, v in kw.items()}
    flux, diag = jax.jit(lambda a, b: fn(lkp, a, b, **kw))(_cast(atm, dtype), _cast(bcs, dtype))
    return flux, diag


def _cols(tree, ncol, lo, hi):
    """Columns [lo, hi) of every column leaf (trailing axis ncol)."""
    return tree_map_columns(
        lambda x: x[..., lo:hi] if x is not None and hasattr(x, "ndim") and x.ndim
        and x.shape[-1] == ncol else x,
        lambda x: x, tree,
    )


def _mask(wave, atm, seed=3, col_offset=0):
    return build_cloud_mask_mcica(
        jax.random.key(seed), atm.cloud_state.cld_frac, NGPT, col_offset=col_offset
    )


# scenario -> (wave, solve kwargs builder, incident fluxes)
SCENARIOS = {
    "lw_noscat_clear": ("lw", lambda a: {}, False),
    "lw_noscat_inc_flux": ("lw", lambda a: {}, True),
    "lw_2stream_clear": ("lw", lambda a: {"two_stream": True}, False),
    "sw_2stream_clear": ("sw", lambda a: {}, False),
    "sw_2stream_inc_diffuse": ("sw", lambda a: {}, True),
    "sw_direct_only": ("sw", lambda a: {"two_stream": False}, False),
    "lw_noscat_mask": ("lw", lambda a: {"lkp_cld": CLD["lw"], "cld_mask": _mask("lw", a)}, False),
    "lw_2stream_mask": (
        "lw", lambda a: {"two_stream": True, "lkp_cld": CLD["lw"], "cld_mask": _mask("lw", a)},
        False,
    ),
    "sw_mask": ("sw", lambda a: {"lkp_cld": CLD["sw"], "cld_mask": _mask("sw", a)}, False),
    "lw_aerosol": ("lw", lambda a: {"two_stream": True, "lkp_aero": AERO["lw"]}, False),
    "sw_aerosol": ("sw", lambda a: {"lkp_aero": AERO["sw"]}, False),
    "lw_cloud_aerosol": (
        "lw",
        lambda a: {"two_stream": True, "lkp_cld": CLD["lw"], "lkp_aero": AERO["lw"],
                   "cld_mask": _mask("lw", a)},
        False,
    ),
    "sw_cloud_aerosol": (
        "sw",
        lambda a: {"lkp_cld": CLD["sw"], "lkp_aero": AERO["sw"], "cld_mask": _mask("sw", a)},
        False,
    ),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_f32_matches_f64(name):
    """Every scenario of the one path: f32 fluxes within f32 roundoff of the
    f64 fluxes of the same problem, diagnostics alike."""
    wave, kw, inc = SCENARIOS[name]
    atm = _atm()
    bcs = _bcs(wave, inc=inc)
    f64, d64 = _solve(wave, atm, bcs, jnp.float64, **kw(atm))
    f32, d32 = _solve(wave, atm, bcs, jnp.float32, **kw(atm))
    assert f32.flux_up.dtype == jnp.float32 and f64.flux_up.dtype == jnp.float64
    assert f32.flux_up.shape == (NLAY + 1, NCOL)
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b), atol=ATOL, rtol=1e-4)
    assert np.all(np.isfinite(np.asarray(f64.flux_dn)))
    if "cld_mask" in kw(atm):
        np.testing.assert_array_equal(np.asarray(d32.cld_cover), np.asarray(d64.cld_cover))
    if wave == "sw" and "lkp_aero" in kw(atm):
        np.testing.assert_allclose(np.asarray(d32.aod_sw_ext), np.asarray(d64.aod_sw_ext),
                                   rtol=1e-5)


@pytest.mark.parametrize("ncol", [1, 3, 130])
@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_ragged_column_counts(wave, ncol):
    """Any column count runs (no alignment), and each column's fluxes do not
    depend on the batch it is solved in."""
    atm = _atm(ncol=ncol)
    bcs = _bcs(wave, ncol=ncol)
    flux, _ = _solve(wave, atm, bcs, jnp.float64)
    assert flux.flux_up.shape == (NLAY + 1, ncol)
    assert np.all(np.isfinite(np.asarray(flux.flux_dn)))
    # column 0 alone == column 0 of the batch
    f1, _ = _solve(wave, _cols(atm, ncol, 0, 1), _cols(bcs, ncol, 0, 1), jnp.float64)
    np.testing.assert_allclose(np.asarray(f1.flux_up), np.asarray(flux.flux_up)[:, :1],
                               rtol=1e-12)


@pytest.mark.parametrize("nlay", [1, 2])
@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_few_layers(wave, nlay):
    """One- and two-layer columns: the recurrences' edge cases."""
    atm = _atm(nlay=nlay)
    bcs = _bcs(wave)
    f64, _ = _solve(wave, atm, bcs, jnp.float64)
    f32, _ = _solve(wave, atm, bcs, jnp.float32)
    assert f64.flux_up.shape == (nlay + 1, NCOL)
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b), atol=ATOL, rtol=1e-4)
    if wave == "sw":
        night = np.asarray(bcs.cos_zenith) <= 0
        assert np.all(np.asarray(f64.flux_dn)[:, night] == 0.0)


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_multi_angle_f32_matches_f64(n_angles):
    """LW no-scat summed over 1-4 Gauss-Jacobi angles, f32 vs f64."""
    atm = _atm()
    bcs = _bcs("lw", inc=True)
    f64, _ = _solve("lw", atm, bcs, jnp.float64, n_gauss_angles=n_angles)
    f32, _ = _solve("lw", atm, bcs, jnp.float32, n_gauss_angles=n_angles)
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b), atol=ATOL, rtol=1e-4)
    # the incident flux splits by angle weight: TOA dn is conserved exactly
    np.testing.assert_allclose(np.asarray(f64.flux_dn)[-1], 0.3 * NGPT, rtol=1e-12)


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_eta_node_modes_agree_off_node(wave):
    """Both eta node semantics run through the whole solve and agree bitwise
    where no eta lands exactly on a grid node (the synthetic atmosphere)."""
    atm = _atm()
    bcs = _bcs(wave)
    fa, _ = _solve(wave, atm, bcs, jnp.float64, eta_node_mode="continuous")
    fb, _ = _solve(wave, atm, bcs, jnp.float64, eta_node_mode="reference")
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="eta node_mode"):
        _solve(wave, atm, bcs, jnp.float64, eta_node_mode="bogus")


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_metric_scaling_scales_every_flux(wave):
    atm = _atm()
    bcs = _bcs(wave)
    scale = jnp.asarray(np.linspace(0.5, 2.0, (NLAY + 1) * NCOL).reshape(NLAY + 1, NCOL))
    f1, _ = _solve(wave, atm, bcs, jnp.float64)
    f2, _ = _solve(wave, atm, bcs, jnp.float64, metric_scaling=scale)
    for a, b in zip(f1, f2):
        np.testing.assert_allclose(np.asarray(a) * np.asarray(scale), np.asarray(b), rtol=1e-14)


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_mcica_seed_equals_explicit_mask(wave):
    """cld_mask_seed samples exactly the mask build_cloud_mask_mcica gives
    for the same key and global columns."""
    atm = _atm()
    bcs = _bcs(wave)
    kw = {"lkp_cld": CLD[wave], "two_stream": True}
    fs, ds = _solve(wave, atm, bcs, jnp.float64, cld_mask_seed=jnp.int32(3), col_offset=5, **kw)
    fm, dm = _solve(wave, atm, bcs, jnp.float64, cld_mask=_mask(wave, atm, 3, 5), **kw)
    for a, b in zip(fs, fm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ds.cld_cover), np.asarray(dm.cld_cover))
    cover = np.asarray(ds.cld_cover)
    assert 0.0 < cover.mean() < 1.0  # fractional clouds: genuinely sampled


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_mcica_invariant_to_col_offset_split(wave):
    """Solving columns [0, 4) and [4, 8) with their global col_offset
    reproduces the 8-column solve: McICA is keyed on global columns."""
    atm = _atm()
    bcs = _bcs(wave)
    kw = {"lkp_cld": CLD[wave], "cld_mask_seed": jnp.int32(9)}
    full, dfull = _solve(wave, atm, bcs, jnp.float64, **kw)
    for lo in (0, 4):
        f, d = _solve(wave, _cols(atm, NCOL, lo, lo + 4), _cols(bcs, NCOL, lo, lo + 4),
                      jnp.float64, col_offset=lo, **kw)
        np.testing.assert_array_equal(np.asarray(d.cld_cover),
                                      np.asarray(dfull.cld_cover)[lo:lo + 4])
        np.testing.assert_allclose(np.asarray(f.flux_up), np.asarray(full.flux_up)[:, lo:lo + 4],
                                   rtol=1e-12)


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_mcica_invariant_to_chunking(wave):
    """solve_chunked in seed mode == the unchunked solve (cloud cover
    bitwise): each chunk receives its global column offset."""
    atm = _atm()
    bcs = _bcs(wave)
    fn = solve_lw if wave == "lw" else solve_sw
    lkp, cld = LKP[wave], CLD[wave]
    seed = jnp.int32(4)
    full = jax.jit(lambda a, b: fn(lkp, a, b, lkp_cld=cld, cld_mask_seed=seed))(atm, bcs)
    chunked = jax.jit(
        lambda a, b: solve_chunked(
            lambda ac, bc, sc, off: fn(lkp, ac, bc, lkp_cld=cld, cld_mask_seed=sc, col_offset=off),
            a, b, 2, cld_mask_seed=seed,
        )
    )(atm, bcs)
    np.testing.assert_array_equal(np.asarray(chunked[1].cld_cover), np.asarray(full[1].cld_cover))
    for a, b in zip(chunked[0], full[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
