"""Multi-host (2-process) equivalence test on CPU.

Spawns TWO separate python processes, each with 4 virtual CPU devices,
joined through ``jax.distributed.initialize`` into one 8-device runtime.
Each process builds only ITS column slice of the atmosphere, assembles
global arrays via parallel.distributed.globalize, runs the column-sharded
solve, and checks its local output shards against a full single-device
reference computed independently — the multi-host analogue of the
sharded-vs-single equivalence test (SURVEY.md section 7 step 6).

Scope: this validates the globalize/column-range plumbing and SPMD
numerical equivalence of the multi-process code path. It is two processes
on ONE box over local loopback — it does not (and cannot, in this
environment) exercise DCN transport, pod-scale init robustness, or real
multi-chip ICI behavior.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
sys.path.insert(0, os.environ["RRTMGP_REPO"])
import jax
import jax.numpy as jnp
import numpy as np

from rrtmgp_tpu.parallel import distributed as dist

pid = int(os.environ["DIST_PID"])
dist.initialize(
    coordinator_address=os.environ["DIST_COORD"], num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()

jax.config.update("jax_enable_x64", True)

from rrtmgp_tpu.data.synthetic import synthetic_gas_lookup, synthetic_atmosphere
from rrtmgp_tpu.models.rrtmgp import solve_lw
from rrtmgp_tpu.parallel.sharding import shard_solve
from rrtmgp_tpu.states import LwBCs

NCOL, NLAY, NGPT, NBND = 32, 8, 16, 2
lkp = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND)
atm_full = synthetic_atmosphere(ncol=NCOL, nlay=NLAY)
bcs_full = LwBCs(sfc_emis=jnp.full((NBND, NCOL), 0.98))

mesh = dist.global_column_mesh()
lo, hi = dist.process_column_range(NCOL, mesh)
assert (lo, hi) == (pid * 16, pid * 16 + 16), (lo, hi)

# each process holds ONLY its local slice, as a host model would
take = lambda t: jax.tree_util.tree_map(
    lambda x: np.asarray(x)[..., lo:hi]
    if hasattr(x, "ndim") and x.ndim and x.shape[-1] == NCOL
    else x,
    t,
)
atm = dist.globalize(take(atm_full), mesh, NCOL)
bcs = dist.globalize(take(bcs_full), mesh, NCOL)

fn = jax.jit(shard_solve(
    lambda a, b: solve_lw(lkp, a, b, two_stream=True)[0], mesh, NCOL
))
flux = fn(atm, bcs)
jax.block_until_ready(flux)

# independent single-device reference on the full problem
ref = jax.jit(lambda a, b: solve_lw(lkp, a, b, two_stream=True)[0])(
    jax.device_put(atm_full, jax.local_devices()[0]),
    jax.device_put(bcs_full, jax.local_devices()[0]),
)

mine = dist.local_values(flux)
np.testing.assert_allclose(
    mine.flux_up, np.asarray(ref.flux_up)[:, lo:hi], rtol=1e-12
)
np.testing.assert_allclose(
    mine.flux_dn, np.asarray(ref.flux_dn)[:, lo:hi], rtol=1e-12
)
print(f"DIST-OK pid={pid}")
"""


@pytest.mark.slow
def test_two_process_column_solve():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["RRTMGP_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["DIST_COORD"] = f"localhost:{port}"
    procs = []
    for pid in range(2):
        e = dict(env)
        e["DIST_PID"] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"pid {pid} rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert f"DIST-OK pid={pid}" in out
