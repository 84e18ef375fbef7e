"""Multi-host (multi-process) wiring for column-parallel solves.

The reference performs ZERO inter-rank communication — each MPI rank runs
RRTMGP on its local columns, with the host model (ClimaAtmos) owning the
decomposition (SURVEY.md section 2: ClimaComms context carried but unused
for communication). This module keeps that property: one
global 1-D column mesh spanning all processes' devices, per-process column
slices, lookup tables replicated, and no collectives anywhere in the solve.
Scaling is pure column throughput.

Usage (one process per host, e.g. under SLURM/GKE):

    from rrtmgp_tpu.parallel import distributed as dist
    dist.initialize()                       # jax.distributed env-driven init
    mesh = dist.global_column_mesh()
    lo, hi = dist.process_column_range(ncol_global, mesh)
    atm_local = build_my_columns(lo, hi)    # host model's local columns
    atm = dist.globalize(atm_local, mesh, ncol_global)
    solver = RRTMGPSolver(..., as_=atm, mesh=mesh)

Every process executes the same program (SPMD); arrays are global
jax.Arrays whose addressable shards live on the local devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import COLUMN_AXIS, make_column_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Start the JAX distributed runtime (idempotent).

    With no arguments, reads the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    cluster JAX detects); on a machine that announces no cluster, pass
    all three explicitly (e.g. coordinator_address='localhost:<port>'). After
    this returns, ``jax.devices()`` spans ALL processes' devices and
    ``jax.local_devices()`` this process's.
    """
    # NOTE: must not touch jax.devices()/process_count() here — any backend
    # query initializes XLA and makes jax.distributed.initialize fail
    if getattr(initialize, "_done", False):
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # tolerate double-init across libraries
        if "already" not in str(e).lower():
            raise
    initialize._done = True


def global_column_mesh() -> Mesh:
    """1-D mesh over ALL processes' devices, in process order (so each
    process owns a contiguous global column range)."""
    return make_column_mesh(jax.devices())


def process_column_range(ncol_global: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """[lo, hi) global column range owned by THIS process under the global
    column mesh. ncol_global must divide evenly by the device count."""
    mesh = mesh or global_column_mesh()
    devices = list(mesh.devices.ravel())
    n_dev = len(devices)
    assert ncol_global % n_dev == 0, (ncol_global, n_dev)
    per_dev = ncol_global // n_dev
    mine = [i for i, d in enumerate(devices) if d.process_index == jax.process_index()]
    assert mine, "this process owns no devices in the mesh"
    assert mine == list(range(mine[0], mine[0] + len(mine))), (
        "process devices are not contiguous in the mesh; build the mesh with "
        "global_column_mesh()"
    )
    return mine[0] * per_dev, (mine[-1] + 1) * per_dev


def globalize(local_tree, mesh: Mesh, ncol_global: int):
    """Assemble per-process local column slices into global jax.Arrays.

    Every leaf whose trailing axis is the LOCAL column count becomes a
    column-sharded global array (this process contributes its slice); every
    other leaf (lookup tables, scalars, global-mean vmr vectors) must be
    identical on all processes and becomes fully replicated.
    """
    lo, hi = process_column_range(ncol_global, mesh)
    ncol_local = hi - lo

    def leaf(x):
        if x is None or not hasattr(x, "ndim"):
            return x
        x = np.asarray(x)
        if x.ndim and x.shape[-1] == ncol_local and ncol_local != ncol_global:
            spec = P(*([None] * (x.ndim - 1)), COLUMN_AXIS)
            return jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), x, (*x.shape[:-1], ncol_global)
            )
        if x.ndim and x.shape[-1] == ncol_global:
            # already-global input (single-process case)
            spec = P(*([None] * (x.ndim - 1)), COLUMN_AXIS)
            return jax.device_put(jax.numpy.asarray(x), NamedSharding(mesh, spec))
        return jax.device_put(jax.numpy.asarray(x), NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(leaf, local_tree)


def local_values(global_tree):
    """This process's contiguous column slice of column-sharded outputs, as
    host numpy arrays (the inverse of globalize for results)."""

    def leaf(x):
        if x is None or not hasattr(x, "addressable_shards"):
            return x
        shards = sorted(x.addressable_shards, key=lambda s: s.index[-1].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=-1)

    return jax.tree_util.tree_map(leaf, global_tree)
