"""Sharding tests: single-device vs 8-device column-sharded equivalence.

The counterpart of the reference's CPU-vs-CUDA same-kernel testing
(SURVEY.md section 4). Runs in a SUBPROCESS with
--xla_force_host_platform_device_count=8 because (a) the virtual-device flag
must be set before jax initializes and (b) 8 virtual devices slow all other
tests' compiles ~10x.
"""

import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, os.environ["RRTMGP_REPO"])
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from rrtmgp_tpu.data.synthetic import synthetic_gas_lookup, synthetic_atmosphere
from rrtmgp_tpu.models.rrtmgp import solve_lw, solve_sw
from rrtmgp_tpu.parallel.sharding import make_column_mesh, replicate, shard_columns
from rrtmgp_tpu.states import LwBCs, SwBCs

assert len(jax.devices()) == 8, jax.devices()

NCOL, NLAY, NGPT, NBND = 32, 12, 16, 2
lkp = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND)
lkp_sw = synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1)
atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY)
bcs_lw = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98))
bcs_sw = SwBCs(
    cos_zenith=jnp.full((NCOL,), 0.6), toa_flux=jnp.full((NCOL,), 1361.0),
    sfc_alb_direct=jnp.full((NBND, NCOL), 0.2), sfc_alb_diffuse=jnp.full((NBND, NCOL), 0.2),
)

# single-device result
f_lw = jax.jit(lambda l, a, b: solve_lw(l, a, b, two_stream=True)[0])
f_sw = jax.jit(lambda l, a, b: solve_sw(l, a, b)[0])
flux0 = f_lw(lkp, atm, bcs_lw)
fsw0 = f_sw(lkp_sw, atm, bcs_sw)

# column-sharded over an 8-device mesh
mesh = make_column_mesh()
atm_s = shard_columns(atm, mesh, NCOL)
bcs_lw_s = shard_columns(bcs_lw, mesh, NCOL)
bcs_sw_s = shard_columns(bcs_sw, mesh, NCOL)
lkp_s = replicate(lkp, mesh)
lkp_sw_s = replicate(lkp_sw, mesh)
flux1 = f_lw(lkp_s, atm_s, bcs_lw_s)
fsw1 = f_sw(lkp_sw_s, atm_s, bcs_sw_s)

np.testing.assert_allclose(np.asarray(flux0.flux_up), np.asarray(flux1.flux_up), rtol=1e-12)
np.testing.assert_allclose(np.asarray(flux0.flux_dn), np.asarray(flux1.flux_dn), rtol=1e-12)
np.testing.assert_allclose(np.asarray(fsw0.flux_up), np.asarray(fsw1.flux_up), rtol=1e-12)
np.testing.assert_allclose(np.asarray(fsw0.flux_dn_dir), np.asarray(fsw1.flux_dn_dir), rtol=1e-12)

# the sharded result must actually be distributed
assert len(flux1.flux_up.sharding.device_set) == 8, flux1.flux_up.sharding
print("SHARDING-EQUIVALENCE-OK")
"""


@pytest.mark.slow
def test_sharded_equivalence():
    _run_subprocess(_SCRIPT, "SHARDING-EQUIVALENCE-OK")


# The PRODUCTION path: the solve under shard_map via RRTMGPSolver(mesh=...).
# Columns sharded 8 ways, tables replicated; McICA seeded on GLOBAL column
# indices, so the sharded cloud cover must reproduce the single-device one
# BITWISE, and the fluxes to f32 summation-order noise.
_SOLVER_SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, os.environ["RRTMGP_REPO"])
import jax
import jax.numpy as jnp
import numpy as np

import rrtmgp_tpu as rt
from rrtmgp_tpu.data.synthetic import (
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu.parallel.sharding import make_column_mesh, shard_columns
from rrtmgp_tpu.states import LwBCs, SwBCs

assert len(jax.devices()) == 8, jax.devices()

NCOL, NLAY, NGPT, NBND = 8 * 8, 8, 16, 2
dtype = np.float32
lookups = rt.LookupBundle(
    lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=dtype),
    lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, dtype=dtype),
    lookup_lw_cld=synthetic_cloud_lookup(n_bnd=NBND, dtype=dtype),
    lookup_sw_cld=synthetic_cloud_lookup(n_bnd=NBND, seed=5, dtype=dtype),
)
atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=dtype, with_clouds=True)
# fractional clouds: the McICA sample must be genuinely stochastic, otherwise
# the bitwise sharding-invariance check is vacuous (cld_frac==1 is deterministic)
import dataclasses
atm = dataclasses.replace(
    atm,
    cloud_state=dataclasses.replace(
        atm.cloud_state, cld_frac=atm.cloud_state.cld_frac * 0.6
    ),
)
bcs_lw = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98, dtype))
bcs_sw = SwBCs(
    cos_zenith=jnp.full((NCOL,), 0.6, dtype),
    toa_flux=jnp.full((NCOL,), 1361.0, dtype),
    sfc_alb_direct=jnp.full((NBND, NCOL), 0.2, dtype),
    sfc_alb_diffuse=jnp.full((NBND, NCOL), 0.2, dtype),
)
gp = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float32)
P = rt.RRTMGPParameters()

def solve(mesh):
    a, bl, bs = atm, bcs_lw, bcs_sw
    if mesh is not None:
        a = shard_columns(a, mesh, NCOL)
        bl = shard_columns(bl, mesh, NCOL)
        bs = shard_columns(bs, mesh, NCOL)
    s = rt.RRTMGPSolver(
        gp, rt.AllSkyRadiation(), P, bl, bs, a, lookups=lookups,
        mesh=mesh,
    )
    flw = s.update_lw_fluxes()   # LW two-stream, McICA by seed
    fsw = s.update_sw_fluxes()   # SW two-stream
    return flw, fsw, s.diag_lw, s.diag_sw

flw0, fsw0, dlw0, dsw0 = solve(None)
mesh = make_column_mesh()
flw1, fsw1, dlw1, dsw1 = solve(mesh)

# McICA streams keyed on global column indices: cloud cover BITWISE equal
for a, b in [(dlw0.cld_cover, dlw1.cld_cover), (dsw0.cld_cover, dsw1.cld_cover)]:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
for a, b in [
    (flw0.flux_up, flw1.flux_up), (flw0.flux_dn, flw1.flux_dn),
    (fsw0.flux_up, fsw1.flux_up), (fsw0.flux_dn, fsw1.flux_dn),
    (fsw0.flux_dn_dir, fsw1.flux_dn_dir),
]:
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-3)
assert bool(jnp.all(jnp.isfinite(flw1.flux_up)))
cov = float(jnp.mean(dlw1.cld_cover))
assert 0.0 < cov < 0.67, cov  # clouds actually sampled, stochastically

# the sharded result must actually be distributed
assert len(flw1.flux_up.sharding.device_set) == 8, flw1.flux_up.sharding
print("SOLVER-SHARDING-EQUIVALENCE-OK")
"""


@pytest.mark.slow
def test_sharded_solver_equivalence():
    _run_subprocess(_SOLVER_SCRIPT, "SOLVER-SHARDING-EQUIVALENCE-OK")


def _run_subprocess(script, token):
    env = dict(os.environ)
    env["RRTMGP_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", script],
        env=env,
        capture_output=True,
        text=True,
        timeout=1200,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    assert token in r.stdout
