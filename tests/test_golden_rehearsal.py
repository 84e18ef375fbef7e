"""Golden-flux pipeline rehearsal.

The real golden tests (tests/test_real_data.py) gate on $RRTMGP_DATA and have
never run in this zero-egress environment — leaving their code (the RFMIP
reader, reference-flux file parsing, orientation/tiling plumbing) unexecuted
until first contact with real data. This module closes that gap WITHOUT the
data: it fabricates a structurally-faithful rrtmgp-data checkout (synthetic
lookup files, an RFMIP-shaped input with 100 sites incl. a night column, and
all-sky example files), generates the "Fortran reference" fluxes by running
THIS framework's f64 XLA solve through the exact same loading procedure, and
then executes the real test_real_data.py suite in a subprocess with
RRTMGP_DATA pointing at the fake checkout.

What this proves: every line of the golden pipeline (artifact paths, both
input readers, the reference-file parsers with their expt/site/level
orientation handling, the tolerance comparisons) runs and passes end to end.
What it cannot prove: agreement with the actual Fortran numbers — that
activates unchanged the day a real rrtmgp-data checkout is supplied. The
NUMERICS themselves are pinned independently by tests/test_oracle*.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_loader as tl  # synthetic lookup-file writers

NSITE = 100       # the real RFMIP file has exactly 100 sites
NLAY = 24
NEXPT = 2         # experiment 0 is the one under test
NCOL_ALLSKY_DS = 4


def _write_rfmip_input(path, lkp_gas_path):
    """RFMIP-shaped input: TOA-first levels, (site, level) C-order, expt axis
    on the per-experiment fields, GM gas scalars, one night column."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(17)
    f = netcdf_file(path, "w")
    f.createDimension("expt", NEXPT)
    f.createDimension("site", NSITE)
    f.createDimension("layer", NLAY)
    f.createDimension("level", NLAY + 1)

    def mk(name, dims, data):
        v = f.createVariable(name, "d", dims)
        v[:] = data
        return v

    # TOA-first levels (index 0 = TOA), within the synthetic table's
    # pressure grid (105000 .. 10 Pa)
    p_lev = np.exp(
        np.linspace(np.log(15.0), np.log(101300.0), NLAY + 1)
    )[None, :] * (1.0 + 0.002 * rng.standard_normal((NSITE, 1)))
    p_lay = 0.5 * (p_lev[:, :-1] + p_lev[:, 1:])
    t_sfc = 288.0 + rng.normal(0, 4, NSITE)
    t_lev = np.clip(
        t_sfc[:, None] + 50.0 * np.log(p_lev / p_lev[:, -1:]) / np.log(1e-1),
        205.0, 315.0,
    )
    t_lay = 0.5 * (t_lev[:, :-1] + t_lev[:, 1:])
    h2o = 8e-3 * (p_lay / p_lay[:, -1:]) ** 2 + 3e-6
    o3 = 5e-8 + 8e-6 * np.exp(-((np.log(p_lay / 2500.0)) ** 2))

    mk("pres_level", ("site", "level"), p_lev)
    mk("pres_layer", ("site", "layer"), p_lay)
    expt = lambda a: np.stack([a, 1.01 * a])  # expt 1 = decoy
    mk("temp_level", ("expt", "site", "level"), expt(t_lev))
    mk("temp_layer", ("expt", "site", "layer"), expt(t_lay))
    mk("water_vapor", ("expt", "site", "layer"), expt(h2o))
    mk("ozone", ("expt", "site", "layer"), expt(o3))
    mk("surface_temperature", ("expt", "site"), expt(t_sfc))
    mk("surface_emissivity", ("site",), np.full(NSITE, 0.98))
    mk("surface_albedo", ("site",), np.full(NSITE, 0.07))
    zen = np.full(NSITE, 52.0)
    zen[3] = 120.0  # night column
    mk("solar_zenith_angle", ("site",), zen)
    mk("total_solar_irradiance", ("site",), np.full(NSITE, 1361.0))
    # GM gases (values pre-scaled; the units-attr parse falls back to 1.0 for
    # netcdf3 files)
    mk("carbon_dioxide_GM", ("expt",), np.array([397e-6, 400e-6]))
    mk("nitrous_oxide_GM", ("expt",), np.array([3.2e-7, 3.3e-7]))
    f.close()


def _write_reference_flux(path, var, flux_sfc_first):
    """Fortran-style reference flux file: (expt, site, level), TOA-first
    level order (matching the input file's orientation)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w")
    nlev, nsite = flux_sfc_first.shape
    f.createDimension("expt", NEXPT)
    f.createDimension("site", nsite)
    f.createDimension("level", nlev)
    a = flux_sfc_first[::-1].T  # (site, level) TOA-first
    v = f.createVariable(var, "d", ("expt", "site", "level"))
    v[:] = np.stack([a, 0.5 * a])  # expt 1 = decoy
    f.close()


def _write_allsky_file(path, band_set, fluxes=None):
    """rrtmgp-allsky-shaped file: TOA-first input column(s) + (optionally)
    the reference fluxes for ``band_set``."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w")
    f.createDimension("lay", NLAY)
    f.createDimension("lev", NLAY + 1)
    f.createDimension("col", NCOL_ALLSKY_DS)

    def mk(name, dims, data):
        v = f.createVariable(name, "d", dims)
        v[:] = data
        return v

    p_lev = np.exp(np.linspace(np.log(15.0), np.log(101300.0), NLAY + 1))[
        :, None
    ] * np.ones((1, NCOL_ALLSKY_DS))
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])
    t_lev = np.clip(
        288.0 + 50.0 * np.log(p_lev / p_lev[-1:]) / np.log(1e-1), 205.0, 315.0
    )
    t_lay = 0.5 * (t_lev[:-1] + t_lev[1:])
    mk("p_lev", ("lev", "col"), p_lev)
    mk("p_lay", ("lay", "col"), p_lay)
    mk("t_lev", ("lev", "col"), t_lev)
    mk("t_lay", ("lay", "col"), t_lay)
    # moderate humidity: the synthetic k-tables are opaque enough that a wet
    # column pushes the LW 2stream-vs-noscat gap past the reference's
    # (real-data-calibrated) 5 W/m^2 gate and the SW f32 sweep past 0.06.
    # Normalize by the SURFACE row (this file is TOA-first, so that is the
    # LAST row): normalizing by row 0 made h2o a ~9e4 "VMR" at the surface,
    # which saturated band-0 eta to exactly 1.0 in f32 (but not f64) and
    # tripped the reference-mode full-cell node jump — 15 W/m^2 of phantom
    # golden error from unphysical data.
    mk("h2o", ("lay", "col"), 1e-3 * (p_lay / p_lay[-1:]) ** 2 + 3e-6)
    mk("o3", ("lay", "col"), np.full((NLAY, NCOL_ALLSKY_DS), 1e-6))
    a_type = np.zeros((NLAY, NCOL_ALLSKY_DS))
    a_size = np.zeros((NLAY, NCOL_ALLSKY_DS))
    a_mass = np.zeros((NLAY, NCOL_ALLSKY_DS))
    a_type[2, 0], a_size[2, 0], a_mass[2, 0] = 1, 1.5, 3e-6    # dust1
    a_type[3, 1], a_size[3, 1], a_mass[3, 1] = 3, 0.0, 2e-6    # sulfate
    a_type[5, 2], a_size[5, 2], a_mass[5, 2] = 12, 2.5, 4e-6   # sea_salt2
    mk("aero_type", ("lay", "col"), a_type)
    mk("aero_size", ("lay", "col"), a_size)
    mk("aero_mass", ("lay", "col"), a_mass)
    if fluxes is not None:
        up, dn = fluxes  # surface-first (nlev, ncol) -> file is TOA-first
        reps_cols = up[::-1][:, :NCOL_ALLSKY_DS]
        mk(f"{band_set}_flux_up", ("lev", "col"), reps_cols)
        mk(f"{band_set}_flux_dn", ("lev", "col"), dn[::-1][:, :NCOL_ALLSKY_DS])
    f.close()


@pytest.fixture(scope="module")
def fake_data_dir(tmp_path_factory):
    """A structurally-faithful rrtmgp-data checkout whose 'Fortran reference'
    fluxes are generated by this framework's own f64 XLA solve through the
    exact loading procedure the golden tests use."""
    import jax
    import jax.numpy as jnp

    from rrtmgp_tpu.data import artifact_paths as ap
    from rrtmgp_tpu.data.allsky import load_allsky_atmosphere
    from rrtmgp_tpu.data.loader import (
        load_aerosol_lookup,
        load_cloud_lookup,
        load_gas_lookup,
    )
    from rrtmgp_tpu.data.rfmip import load_rfmip_atmosphere
    from rrtmgp_tpu.models.rrtmgp import solve_lw, solve_sw
    from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica
    from rrtmgp_tpu.parameters import RRTMGPParameters
    from rrtmgp_tpu.states import LwBCs, SwBCs

    root = tmp_path_factory.mktemp("rrtmgp-data")
    rfmip_dir = root / "examples" / "rfmip-clear-sky"
    (rfmip_dir / "inputs").mkdir(parents=True)
    (rfmip_dir / "reference").mkdir(parents=True)
    allsky_ref = root / "examples" / "all-sky" / "reference"
    allsky_ref.mkdir(parents=True)

    # lookup files (synthetic, small dims; filenames are the v1.9 names)
    tl._write_gas_nc(str(root / "rrtmgp-gas-lw-g256.nc"), longwave=True)
    tl._write_gas_nc(str(root / "rrtmgp-gas-sw-g224.nc"), longwave=False)
    tl._write_cloud_nc(str(root / "rrtmgp-clouds-lw-bnd.nc"))
    tl._write_cloud_nc(str(root / "rrtmgp-clouds-sw-bnd.nc"))
    tl._write_aerosol_nc(str(root / "rrtmgp-aerosols-merra-lw.nc"))
    tl._write_aerosol_nc(str(root / "rrtmgp-aerosols-merra-sw.nc"))

    rfmip_in = str(
        rfmip_dir / "inputs"
        / "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc"
    )
    _write_rfmip_input(rfmip_in, str(root / "rrtmgp-gas-lw-g256.nc"))

    params = RRTMGPParameters(
        grav=9.80665, molmass_dryair=0.028964, molmass_water=0.018016
    )
    lkp_lw = load_gas_lookup(str(root / "rrtmgp-gas-lw-g256.nc"))
    lkp_sw = load_gas_lookup(str(root / "rrtmgp-gas-sw-g224.nc"))

    # ---- clear-sky reference fluxes via the RFMIP reader + f64 solve ----
    atm, sfc_emis, sfc_alb, cos_zenith, toa_flux = load_rfmip_atmosphere(
        rfmip_in, lkp_lw, ncol=NSITE, expt_no=0, params=params
    )
    bcs_lw = LwBCs(
        sfc_emis=jnp.broadcast_to(sfc_emis[None, :], (lkp_lw.n_bnd, NSITE))
    )
    # fake goldens are generated in eta_node_mode="reference" — the mode the
    # real-data golden run defaults to (test_real_data.ETA_NODE_MODE)
    flw, _ = jax.jit(
        lambda a, b: solve_lw(lkp_lw, a, b, eta_node_mode="reference")
    )(atm, bcs_lw)
    bcs_sw = SwBCs(
        cos_zenith=cos_zenith,
        toa_flux=toa_flux,
        sfc_alb_direct=jnp.broadcast_to(sfc_alb[None, :], (lkp_sw.n_bnd, NSITE)),
        sfc_alb_diffuse=jnp.broadcast_to(sfc_alb[None, :], (lkp_sw.n_bnd, NSITE)),
    )
    fsw, _ = jax.jit(
        lambda a, b: solve_sw(lkp_sw, a, b, eta_node_mode="reference")
    )(atm, bcs_sw)
    suffix = "_Efx_RTE-RRTMGP-181204_rad-irf_r1i1p1f1_gn.nc"
    ref = rfmip_dir / "reference"
    _write_reference_flux(str(ref / f"rlu{suffix}"), "rlu", np.asarray(flw.flux_up))
    _write_reference_flux(str(ref / f"rld{suffix}"), "rld", np.asarray(flw.flux_dn))
    _write_reference_flux(str(ref / f"rsu{suffix}"), "rsu", np.asarray(fsw.flux_up))
    _write_reference_flux(str(ref / f"rsd{suffix}"), "rsd", np.asarray(fsw.flux_dn))

    # ---- all-sky reference fluxes via the all-sky reader + f64 solve ----
    lkp_cld_lw = load_cloud_lookup(str(root / "rrtmgp-clouds-lw-bnd.nc"))
    lkp_cld_sw = load_cloud_lookup(str(root / "rrtmgp-clouds-sw-bnd.nc"))
    lkp_aero_lw = load_aerosol_lookup(str(root / "rrtmgp-aerosols-merra-lw.nc"))
    lkp_aero_sw = load_aerosol_lookup(str(root / "rrtmgp-aerosols-merra-sw.nc"))
    ncol_as = 128
    for band_set, lkp, lkp_cld in (
        ("lw", lkp_lw, lkp_cld_lw), ("sw", lkp_sw, lkp_cld_sw)
    ):
        for with_aero, fname in (
            (False, f"rrtmgp-allsky-{band_set}-no-aerosols.nc"),
            (True, f"rrtmgp-allsky-{band_set}.nc"),
        ):
            # write input-only first, read it back with the production
            # reader, solve, then rewrite the file with its reference fluxes
            path = str(allsky_ref / fname)
            _write_allsky_file(path, band_set)
            atm_as, _ = load_allsky_atmosphere(
                path, lkp, lkp_cld, ncol=ncol_as, cldfrac=1.0,
                with_aerosols=with_aero, params=params,
            )
            mask = build_cloud_mask_mcica(
                jax.random.key(0), atm_as.cloud_state.cld_frac, lkp.n_gpt
            )
            lkp_aero = (
                (lkp_aero_lw if band_set == "lw" else lkp_aero_sw)
                if with_aero else None
            )
            if band_set == "lw":
                b = LwBCs(sfc_emis=jnp.full((lkp.n_bnd, ncol_as), 0.98))
                flux, _ = jax.jit(
                    lambda a, bb, m: solve_lw(
                        lkp, a, bb, lkp_cld=lkp_cld, lkp_aero=lkp_aero,
                        cld_mask=m, eta_node_mode="reference",
                    )
                )(atm_as, b, mask)
            else:
                b = SwBCs(
                    cos_zenith=jnp.full((ncol_as,), 0.86),
                    toa_flux=jnp.full((ncol_as,), float(lkp.solar_src_tot)),
                    sfc_alb_direct=jnp.full((lkp.n_bnd, ncol_as), 0.06),
                    sfc_alb_diffuse=jnp.full((lkp.n_bnd, ncol_as), 0.06),
                )
                flux, _ = jax.jit(
                    lambda a, bb, m: solve_sw(
                        lkp, a, bb, lkp_cld=lkp_cld, lkp_aero=lkp_aero,
                        cld_mask=m, eta_node_mode="reference",
                    )
                )(atm_as, b, mask)
            _write_allsky_file(
                path, band_set,
                fluxes=(np.asarray(flux.flux_up), np.asarray(flux.flux_dn)),
            )
    return str(root)


def test_rfmip_reader_contract(fake_data_dir):
    """load_rfmip_atmosphere orientation/tiling/clamping invariants on the
    RFMIP-shaped file: surface-first output, TOA pressure clamped to the
    table minimum, GM gases populated, night column present."""
    from rrtmgp_tpu.data.loader import load_gas_lookup
    from rrtmgp_tpu.data.rfmip import load_rfmip_atmosphere

    lkp = load_gas_lookup(os.path.join(fake_data_dir, "rrtmgp-gas-lw-g256.nc"))
    path = os.path.join(
        fake_data_dir, "examples", "rfmip-clear-sky", "inputs",
        "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc",
    )
    atm, sfc_emis, sfc_alb, cosz, toa = load_rfmip_atmosphere(
        path, lkp, ncol=NSITE, expt_no=0
    )
    p = np.asarray(atm.p_lev)
    assert p.shape == (NLAY + 1, NSITE)
    assert np.all(p[0] > p[-1])                      # surface-first
    np.testing.assert_allclose(p[-1], lkp.p_ref_min)  # TOA clamp
    assert float(atm.vmr.vmr[2]) == pytest.approx(397e-6)  # co2 expt 0
    assert np.asarray(cosz)[3] < 0.0                 # night column
    assert np.all(np.asarray(atm.col_dry) > 0.0)


@pytest.mark.slow
@pytest.mark.parametrize("eta_mode", ["reference", "continuous"])
def test_golden_suite_executes_end_to_end(fake_data_dir, eta_mode):
    """Run the REAL golden suite (tests/test_real_data.py) against the fake
    checkout: all 18 golden tests — the reference's full matrix, {clear, allsky
    ±aerosols} x {LW noscat, LW 2stream} x {f64, f32} + SW tiers (ref
    test/runtests.jl:18-61) — must execute and pass. The f64 no-scat/SW
    references were generated by the same f64 solve (agreement exact); the
    f32 and LW-2stream tiers exercise the reference's loosened tolerances
    against those same no-scat-rescaled files, exactly as the reference does
    (clear_sky_utils.jl:177-179). This certifies the pipeline, not the
    Fortran numbers.

    Rehearsed in BOTH eta node modes: the fake goldens were generated in
    "reference" mode; the fake atmospheres never land eta exactly on a grid
    node (all key-species VMRs > 0), so both modes must agree — pinning that
    the mode switch only acts at exact nodes (the on-node divergence itself
    is pinned by tests/test_oracle.py::test_eta_node_mode_on_node)."""
    env = dict(os.environ)
    env["RRTMGP_DATA"] = fake_data_dir
    env["RRTMGP_ETA_NODE_MODE"] = eta_mode
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_real_data.py", "-q"],
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True,
        text=True,
        timeout=2400,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert "18 passed" in r.stdout, r.stdout[-2000:]


@pytest.mark.slow
def test_golden_contact_script(fake_data_dir):
    """Rehearse scripts/golden_contact.py end to end against the fake
    checkout: identity check runs and correctly flags the non-v1.9 tree,
    --allow-unpinned + --lenient then proceed through structure validation
    and the golden matrix, and the parity report table is emitted with
    per-case L-inf numbers. --modes reference bounds the cost (the
    continuous-mode matrix is already rehearsed by
    test_golden_suite_executes_end_to_end)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("RRTMGP_DATA", None)
    script = os.path.join(repo, "scripts", "golden_contact.py")

    # 1. pristine-pin gate: a fabricated checkout must ABORT by default
    r = subprocess.run(
        [sys.executable, script, fake_data_dir],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 3, r.stdout[-2000:]
    assert "MISMATCH" in r.stdout and "ABORT" in r.stdout

    # 2. forced run: unpinned + lenient -> matrix runs, report emitted
    r = subprocess.run(
        [sys.executable, script, fake_data_dir, "--allow-unpinned",
         "--lenient", "--modes", "reference"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=2400,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert "structure: OK" in r.stdout, r.stdout[-3000:]
    assert "## Parity report" in r.stdout
    # per-case rows parsed from the matrix output (18 tests -> 14 L-inf
    # lines: 12 LW/SW golden prints + 2 clear-sky SW; night-column asserts
    # print nothing). At least the clear-sky rows must be present.
    assert "clear-sky LW noscat float64" in r.stdout
    assert "unpinned" in r.stdout  # honest verdict line
