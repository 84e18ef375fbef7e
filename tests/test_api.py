"""High-level API tests: RRTMGPSolver + radiation methods + getter surface.

Mirrors the reference's API exercise inside the all-sky test
(/root/reference/test/all_sky_with_aerosols_utils.jl:116-133, method list
test/api_method_utils.jl:2-38).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import rrtmgp_tpu as rt
from rrtmgp_tpu.data.synthetic import (
    synthetic_aerosol_lookup,
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu.models.gray import GrayOpticalThicknessSchneider2004, setup_gray_as_pr_grid
from rrtmgp_tpu.parameters import RRTMGPParameters

NBND_LW, NBND_SW = 2, 2
NCOL, NLAY = 8, 30
PARAMS = RRTMGPParameters()

LOOKUPS = rt.LookupBundle(
    lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=16, n_bnd=NBND_LW),
    lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=16, n_bnd=NBND_SW, seed=1),
    lookup_lw_cld=synthetic_cloud_lookup(n_bnd=NBND_LW),
    lookup_sw_cld=synthetic_cloud_lookup(n_bnd=NBND_SW, seed=5),
    lookup_lw_aero=synthetic_aerosol_lookup(n_bnd=NBND_LW),
    lookup_sw_aero=synthetic_aerosol_lookup(n_bnd=NBND_SW, seed=6),
)

API_METHODS = [
    # test/api_method_utils.jl:2-38 (clear_* and center_z/face_z need their modes)
    "top_of_atmosphere_lw_flux_dn", "top_of_atmosphere_diffuse_sw_flux_dn",
    "lw_flux_up", "lw_flux_dn", "lw_flux_net", "surface_emissivity",
    "sw_flux_up", "sw_flux_dn", "sw_flux_net", "sw_direct_flux_dn",
    "cloud_liquid_effective_radius", "cloud_ice_effective_radius",
    "cloud_liquid_water_path", "cloud_ice_water_path", "cloud_fraction",
    "aod_sw_extinction", "aod_sw_scattering", "cos_zenith", "toa_flux",
    "direct_sw_surface_albedo", "diffuse_sw_surface_albedo",
    "surface_temperature", "pressure", "temperature",
    "optical_thickness_parameter", "relative_humidity",
    "sw_cloud_cover", "lw_cloud_cover",
]


def _solver(method):
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, with_aerosols=True)
    gp = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float64)
    bcs_lw = rt.LwBCs(sfc_emis=jnp.full((NBND_LW, NCOL), 0.98))
    bcs_sw = rt.SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.6),
        toa_flux=jnp.full((NCOL,), 1361.0),
        sfc_alb_direct=jnp.full((NBND_SW, NCOL), 0.2),
        sfc_alb_diffuse=jnp.full((NBND_SW, NCOL), 0.2),
    )
    return rt.RRTMGPSolver(gp, method, PARAMS, bcs_lw, bcs_sw, atm, lookups=LOOKUPS)


@pytest.mark.parametrize(
    "method",
    [
        rt.ClearSkyRadiation(False),
        rt.ClearSkyRadiation(True),
        rt.AllSkyRadiation(True, reset_rng_seed=True),
    ],
)
def test_solver_modes(method):
    s = _solver(method)
    s.update_lw_fluxes()
    s.update_sw_fluxes()
    assert s.lw_flux_up().shape == (NLAY + 1, NCOL)
    assert bool(jnp.all(jnp.isfinite(s.lw_flux_up())))
    assert bool(jnp.all(jnp.isfinite(s.sw_flux_up())))
    for name in API_METHODS:
        getattr(s, name)()  # must not raise


def test_clear_sky_diagnostics_double_solve():
    """AllSkyWithClearSkyDiagnostics runs clear then cloudy (ref api.jl:132-176);
    the clear diagnostic must equal a pure clear-sky solve, and differ from
    the cloudy fluxes."""
    s = _solver(rt.AllSkyRadiationWithClearSkyDiagnostics(True, True))
    s.update_lw_fluxes()
    s.update_sw_fluxes()
    s_clear = _solver(rt.ClearSkyRadiation(True))
    s_clear.update_lw_fluxes()
    np.testing.assert_allclose(
        np.asarray(s.clear_lw_flux_up()), np.asarray(s_clear.lw_flux_up()), rtol=1e-12
    )
    assert float(jnp.max(jnp.abs(s.clear_lw_flux_up() - s.lw_flux_up()))) > 1e-3
    assert s.clear_sw_flux_up() is not None


def test_mcica_reproducibility():
    """reset_rng_seed contract: same step -> identical fluxes; different step
    -> different McICA sampling (with fractional cloud cover)."""
    s = _solver(rt.AllSkyRadiation(False, reset_rng_seed=True))
    # fractional cloud cover so sampling matters
    cs = s.as_.cloud_state
    s.as_ = dataclasses.replace(
        s.as_, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * 0.5)
    )
    s.advance_step(7)
    f1 = s.update_lw_fluxes()
    s.advance_step(7)
    f2 = s.update_lw_fluxes()
    np.testing.assert_array_equal(np.asarray(f1.flux_up), np.asarray(f2.flux_up))
    s.advance_step(8)
    f3 = s.update_lw_fluxes()
    assert float(jnp.max(jnp.abs(f3.flux_up - f1.flux_up))) > 0.0


@pytest.mark.parametrize(
    "method",
    [
        rt.ClearSkyRadiation(True),
        rt.AllSkyRadiation(True, reset_rng_seed=True),
        rt.AllSkyRadiationWithClearSkyDiagnostics(True, True),
    ],
)
def test_update_fluxes_fused_pair(method):
    """update_fluxes() (one jitted LW+SW program per step — removes the
    inter-jit host dispatch gap) must equal the separate
    update_lw_fluxes()/update_sw_fluxes() calls bitwise: same solves, same
    McICA keys, only the dispatch granularity differs."""
    s_sep = _solver(method)
    s_sep.advance_step(3)
    flw_sep = s_sep.update_lw_fluxes()
    fsw_sep = s_sep.update_sw_fluxes()

    s_fus = _solver(method)
    s_fus.advance_step(3)
    flw, fsw = s_fus.update_fluxes()
    for a, b in ((flw, flw_sep), (fsw, fsw_sep)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if isinstance(method, rt.AllSkyRadiationWithClearSkyDiagnostics):
        np.testing.assert_array_equal(
            np.asarray(s_fus.clear_lw_flux_up()), np.asarray(s_sep.clear_lw_flux_up())
        )
    if s_sep.sw_cloud_cover() is not None:
        np.testing.assert_array_equal(
            np.asarray(s_fus.sw_cloud_cover()), np.asarray(s_sep.sw_cloud_cover())
        )


def test_f64_auto_chunk(monkeypatch):
    """f64 solves above the memory budget route through solve_chunked
    automatically (the f64 XLA path materializes (nlay, ncol, ngpt) spectral
    tensors — at DYAMOND ncol that OOMs a chip; the reference runs f64
    first-class, ref test/runtests.jl:27-30) and reproduce the unchunked
    fluxes + diagnostics, incl. the McICA stream (global-column keying)."""
    method = rt.AllSkyRadiation(True, reset_rng_seed=True)
    s_ref = _solver(method)
    assert s_ref.auto_chunk is None
    f_lw_ref = s_ref.update_lw_fluxes()
    f_sw_ref = s_ref.update_sw_fluxes()

    # tiny budget: 3.5 columns' worth -> cmax=3 -> chunk = largest power of
    # two <= cmax = 2 (budget-derived, NOT a divisor of ncol: the chunked
    # solve edge-pads columns to a chunk multiple and slices back)
    per_col = rt.api.f64_bytes_per_column(NLAY, 16)
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", str(3.5 * per_col / 1e9))
    with pytest.warns(UserWarning, match="auto-chunking"):
        s = _solver(method)
    assert s.auto_chunk == 2
    f_lw = s.update_lw_fluxes()
    f_sw = s.update_sw_fluxes()
    for a, b in ((f_lw, f_lw_ref), (f_sw, f_sw_ref)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-12)
    # diagnostics survive the chunked path (cld_cover / AOD re-concatenated)
    np.testing.assert_allclose(
        np.asarray(s.sw_cloud_cover()), np.asarray(s_ref.sw_cloud_cover()),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(s.aod_sw_extinction()), np.asarray(s_ref.aod_sw_extinction()),
        rtol=1e-12,
    )


def test_gray_radiation_mode():
    lat = jnp.linspace(-60.0, 60.0, NCOL)
    atm = setup_gray_as_pr_grid(
        40, lat, 100000.0, 9000.0, GrayOpticalThicknessSchneider2004(), PARAMS, dtype=jnp.float64
    )
    gp = rt.RRTMGPGridParams(nlay=40, ncol=NCOL, dtype=jnp.float64)
    bcs_lw = rt.LwBCs(sfc_emis=jnp.ones((1, NCOL)))
    bcs_sw = rt.SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.5),
        toa_flux=jnp.full((NCOL,), 1361.0),
        sfc_alb_direct=jnp.full((1, NCOL), 0.1),
        sfc_alb_diffuse=jnp.full((1, NCOL), 0.1),
    )
    s = rt.RRTMGPSolver(gp, rt.GrayRadiation(), PARAMS, bcs_lw, bcs_sw, atm)
    # every solver exposes auto_chunk, incl. gray (whose _build_solvers
    # returns early — regression: AttributeError)
    assert s.auto_chunk is None
    s.update_lw_fluxes()
    s.update_sw_fluxes()
    assert bool(jnp.all(jnp.isfinite(s.lw_flux_up())))
    assert bool(jnp.all(jnp.isfinite(s.sw_direct_flux_dn())))


def test_name_lists_and_views():
    assert len(rt.aerosol_names()) == 15
    assert set(rt.aerosol_names()) == set(rt.api.AEROSOL_INDEX)
    assert len(rt.gas_names_sw()) == 21
    x = jnp.zeros((11, 4))
    assert rt.domain_view(True, x).shape == (10, 4)
    assert rt.domain_view(False, x).shape == (11, 4)


def test_solver_domain_view_getters():
    """With isothermal_boundary_layer set, the layer-quantity getters drop the
    extra TOP layer (ref api_methods.jl:17-42; vertical axis leading here)."""
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, with_aerosols=True)
    bcs_lw = rt.LwBCs(sfc_emis=jnp.full((NBND_LW, NCOL), 0.98))
    bcs_sw = rt.SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.6),
        toa_flux=jnp.full((NCOL,), 1361.0),
        sfc_alb_direct=jnp.full((NBND_SW, NCOL), 0.2),
        sfc_alb_diffuse=jnp.full((NBND_SW, NCOL), 0.2),
    )
    gp = rt.RRTMGPGridParams(
        nlay=NLAY, ncol=NCOL, dtype=jnp.float64, isothermal_boundary_layer=True
    )
    s = rt.RRTMGPSolver(gp, rt.ClearSkyRadiation(False), PARAMS, bcs_lw, bcs_sw, atm,
                        lookups=LOOKUPS)
    assert s.isothermal_boundary_layer() is True
    assert s.pressure().shape == (NLAY - 1, NCOL)
    assert s.temperature().shape == (NLAY - 1, NCOL)
    assert s.relative_humidity().shape == (NLAY - 1, NCOL)
    # the retained layers are the bottom ones (level/layer 0 = surface)
    np.testing.assert_array_equal(np.asarray(s.pressure()), np.asarray(atm.p_lay[:-1]))
    assert s.domain_view(None) is None
    # flag off: getters return the full layer range
    gp0 = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float64)
    s0 = rt.RRTMGPSolver(gp0, rt.ClearSkyRadiation(False), PARAMS, bcs_lw, bcs_sw, atm,
                         lookups=LOOKUPS)
    assert s0.temperature().shape == (NLAY, NCOL)


def test_volume_mixing_ratio_and_aero_getters():
    s = _solver(rt.ClearSkyRadiation(True))
    h2o = s.volume_mixing_ratio("h2o")
    assert h2o.shape == (NLAY, NCOL)
    co2 = s.volume_mixing_ratio("co2")
    assert float(co2) == pytest.approx(397e-6)
    r = s.aero_radius("dust1")
    assert r.shape == (NLAY, NCOL)
    m = s.aero_column_mass_density("sulfate")
    assert float(jnp.max(m)) > 0.0


def test_solver_metric_scaling():
    """RRTMGPSolver(metric_scaling=...) scales all fluxes (ref
    Fluxes.jl:227-236 via the RTESolver metric_scaling argument); scaling=2
    doubles the unscaled fluxes exactly."""
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, with_aerosols=True)
    gp = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float64)
    bcs_lw = rt.LwBCs(sfc_emis=jnp.full((NBND_LW, NCOL), 0.98))
    bcs_sw = rt.SwBCs(
        cos_zenith=jnp.full((NCOL,), 0.6),
        toa_flux=jnp.full((NCOL,), 1361.0),
        sfc_alb_direct=jnp.full((NBND_SW, NCOL), 0.2),
        sfc_alb_diffuse=jnp.full((NBND_SW, NCOL), 0.2),
    )
    mk = lambda ms: rt.RRTMGPSolver(
        gp, rt.ClearSkyRadiation(True), PARAMS, bcs_lw, bcs_sw, atm,
        lookups=LOOKUPS, metric_scaling=ms,
    )
    s1 = mk(None)
    s2 = mk(jnp.full((NLAY + 1, NCOL), 2.0))
    f1 = s1.update_lw_fluxes()
    f2 = s2.update_lw_fluxes()
    np.testing.assert_allclose(2.0 * np.asarray(f1.flux_up), np.asarray(f2.flux_up), rtol=1e-15)
    g1 = s1.update_sw_fluxes()
    g2 = s2.update_sw_fluxes()
    np.testing.assert_allclose(2.0 * np.asarray(g1.flux_dn), np.asarray(g2.flux_dn), rtol=1e-15)


def test_n_gauss_angles_lw_noscat():
    """RRTMGPSolver(n_gauss_angles=...) threads the Gauss-Jacobi-5 quadrature
    order into the LW no-scat solve (ref carries AngularDiscretization in the
    solver container, /root/reference/src/optics/RTE.jl:61-70, table
    src/optics/AngularDiscretizations.jl:32-54). Two angles must change the
    fluxes plausibly (small, finite, same-sign magnitudes) vs one angle."""
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY)
    gp = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float64)
    bcs_lw = rt.LwBCs(sfc_emis=jnp.full((NBND_LW, NCOL), 0.98))
    mk = lambda n: rt.RRTMGPSolver(
        gp, rt.ClearSkyRadiation(False), PARAMS, bcs_lw, None, atm,
        lookups=LOOKUPS, two_stream_lw=False, n_gauss_angles=n,
    )
    ups = {}
    for n in (1, 2, 3):
        s = mk(n)
        f = s.update_lw_fluxes()
        up = np.asarray(f.flux_up)
        assert np.all(np.isfinite(up)) and np.all(up > 0.0)
        ups[n] = up
    # more angles refine the hemispheric integral: changed, but by a
    # fraction of the flux, and the 2->3 refinement is smaller than 1->2
    d12 = np.max(np.abs(ups[2] - ups[1]))
    d23 = np.max(np.abs(ups[3] - ups[2]))
    assert 0.0 < d12 < 0.1 * np.max(ups[1])
    assert d23 < d12


def test_n_gauss_angles_inc_flux_split():
    """With a TOA incident flux, the angle-weight split must conserve the
    prescribed TOA downward flux exactly for any quadrature order."""
    from rrtmgp_tpu.models.rrtmgp import solve_lw

    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY)
    inc = jnp.full((NCOL, LOOKUPS.lookup_lw.n_gpt), 0.5)
    for n in (1, 2, 4):
        bcs = rt.LwBCs(sfc_emis=jnp.full((NBND_LW, NCOL), 0.98), inc_flux=inc)
        flux, _ = solve_lw(LOOKUPS.lookup_lw, atm, bcs, two_stream=False,
                           n_gauss_angles=n)
        toa_dn = np.asarray(flux.flux_dn)[-1]
        np.testing.assert_allclose(toa_dn, 0.5 * LOOKUPS.lookup_lw.n_gpt,
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# f64 memory sizing (api.chunk_budget_bytes / auto_chunk_size)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ncol, per_col, budget, want",
    [
        (100, 1.0, None, None),       # no budget (the CPU): never chunk
        (100, 1.0, 100.0, None),      # fits exactly
        (100, 1.0, 64.0, 64),         # budget of a power of two columns
        (100, 1.0, 50.0, 32),         # largest power of two <= 50
        (11332, 1.45e6, 3.19e10, None),  # H100 default budget, phase-5 size
        (100, 10.0, 5.0, 1),          # not even one column: one at a time
    ],
)
def test_auto_chunk_size(ncol, per_col, budget, want):
    assert rt.api.auto_chunk_size(ncol, per_col, budget) == want


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats, want",
    [
        ({"bytes_limit": 63763120128}, 0.5 * 63763120128),
        ({"bytes_in_use": 0}, None),
        (None, None),
    ],
)
def test_chunk_budget_from_device(monkeypatch, stats, want):
    monkeypatch.delenv("RRTMGP_CHUNK_BUDGET_GB", raising=False)
    assert rt.api.chunk_budget_bytes(_FakeDevice(stats)) == want


def test_chunk_budget_env_override(monkeypatch):
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", "2.5")
    assert rt.api.chunk_budget_bytes(_FakeDevice({"bytes_limit": 1})) == 2.5e9


def test_f64_bytes_per_column_scales_with_spectral_size():
    per = rt.api.f64_bytes_per_column
    assert per(60, 256) == 60 * 256 * rt.api.F64_BYTES_PER_ELEMENT
    assert per(120, 256) == 2 * per(60, 256)


def test_cpu_solver_does_not_auto_chunk(monkeypatch):
    """The CPU reports no bytes_limit: an f64 solver there is not chunked
    unless $RRTMGP_CHUNK_BUDGET_GB asks for it."""
    monkeypatch.delenv("RRTMGP_CHUNK_BUDGET_GB", raising=False)
    assert _solver(rt.ClearSkyRadiation(False)).auto_chunk is None


@pytest.mark.parametrize("option", ["use_pallas", "pallas_windowed", "f64_kernel"])
def test_removed_options_rejected(option):
    with pytest.raises(TypeError, match=option):
        rt.RRTMGPSolver(
            rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float64),
            rt.ClearSkyRadiation(), PARAMS, None, None,
            synthetic_atmosphere(ncol=NCOL, nlay=NLAY), lookups=LOOKUPS, **{option: True},
        )


@pytest.mark.parametrize(
    "method", [rt.ClearSkyRadiation(True), rt.AllSkyRadiation(True, reset_rng_seed=True)]
)
def test_lower_update_fluxes(method):
    """The program update_fluxes() runs, lowered: it compiles, reports its
    memory, and computes what update_fluxes() stores."""
    s = _solver(method)
    s.advance_step(2)
    compiled = s.lower_update_fluxes().compile()
    assert compiled.memory_analysis() is not None
    (flw, _), (fsw, _) = compiled(*(
        (s.as_, s.bcs_lw, s.bcs_sw) if isinstance(method, rt.ClearSkyRadiation)
        else (s.as_, s.bcs_lw, s.bcs_sw, s._mcica_key(0), s._mcica_key(1), s._col_ids)
    ))
    s.update_fluxes()
    np.testing.assert_array_equal(np.asarray(flw.flux_up), np.asarray(s.lw_flux_up()))
    np.testing.assert_array_equal(np.asarray(fsw.flux_dn), np.asarray(s.sw_flux_dn()))


def test_lower_update_fluxes_refuses_two_program_methods():
    s = _solver(rt.AllSkyRadiationWithClearSkyDiagnostics(True, True))
    with pytest.raises(TypeError, match="more than one program"):
        s.lower_update_fluxes()
