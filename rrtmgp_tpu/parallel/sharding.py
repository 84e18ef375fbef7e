"""Column sharding over device meshes.

The reference's only parallel strategy is embarrassingly-parallel domain
decomposition over columns (SURVEY.md section 2: ClimaComms threads / one CUDA
thread per column; multi-node handled by the host model with zero inter-rank
communication). Here: a 1-D device mesh over the column
axis, ``NamedSharding`` on every per-column array, lookup tables replicated.
No collectives exist on the hot path — XLA partitions the whole solve
per-device; scaling is pure column throughput.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh;
the same program runs SPMD across processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..states import tree_map_columns as _tree_map_columns

COLUMN_AXIS = "col"


def make_column_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'col'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (COLUMN_AXIS,))


def column_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for an array whose LAST axis is columns."""
    return NamedSharding(mesh, P(*([None] * 0), COLUMN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _shard_leaf(x, mesh: Mesh, ncol: int):
    """Shard a pytree leaf on its trailing axis iff that axis is the column
    axis (size == ncol); replicate everything else (lookup tables, global-mean
    vmr vectors, scalars)."""
    if not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != ncol:
        return jax.device_put(x, replicated(mesh))
    spec = P(*([None] * (x.ndim - 1)), COLUMN_AXIS)
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_columns(tree, mesh: Mesh, ncol: int):
    """device_put a state/BC pytree with columns sharded over the mesh.

    ``ncol`` disambiguates the column axis from same-trailing-size non-column
    leaves (the VmrGM global-mean vector is excluded structurally — see
    states.tree_map_columns); choose ncol a multiple of mesh size.
    """
    return _tree_map_columns(
        lambda x: _shard_leaf(x, mesh, ncol),
        lambda x: jax.device_put(x, replicated(mesh)),
        tree,
    )


def replicate(tree, mesh: Mesh):
    """device_put a pytree (e.g. lookup tables) fully replicated."""
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, replicated(mesh)), tree)


def _col_pspec(x, ncol: int):
    """PartitionSpec for one leaf: shard the trailing axis iff it is the
    column axis (size == ncol), else fully replicated."""
    if x is None or not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != ncol:
        return P()
    return P(*([None] * (x.ndim - 1)), COLUMN_AXIS)


def shard_solve(fn, mesh: Mesh, ncol: int):
    """shard_map a pure solve over the column mesh.

    ``shard_map`` runs ``fn`` per shard on its local columns, so the solve is
    partitioned by construction rather than left to the SPMD partitioner —
    the counterpart of the reference's same-kernel CPU/CUDA duality
    (/root/reference/ext/RRTMGPCUDAExt.jl:42-50, one thread per column; here
    one mesh slice per device, zero collectives) — and each shard knows its
    global column offset, which keeps McICA sampling mesh-invariant.

    Every argument/output leaf whose trailing axis is the GLOBAL column axis
    (size ``ncol``) is sharded over 'col'; everything else (lookup tables,
    scalar seeds, global-mean vmr vectors) is replicated. ``fn`` must accept
    per-shard column counts (ncol / mesh size). Output structure is
    discovered with ``eval_shape``, detecting column leaves by trailing size
    ncol/n_devices.

    Inside ``fn``, recover the shard's global column offset with
    ``jax.lax.axis_index('col') * (ncol // n_devices)`` and pass it to
    solve_lw/solve_sw's ``col_offset`` so McICA sampling is invariant to the
    mesh layout.
    """
    n_dev = int(np.prod(mesh.devices.shape))
    assert ncol % n_dev == 0, (ncol, n_dev)
    ncol_shard = ncol // n_dev

    def wrapped(*args):
        in_specs = _tree_map_columns(
            lambda x: _col_pspec(x, ncol), lambda x: P(), args
        )
        # discover the output pytree by abstractly evaluating one shard
        def _struct(shape_fn):
            return lambda x: (
                jax.ShapeDtypeStruct(shape_fn(x), x.dtype)
                if hasattr(x, "shape")
                else x
            )

        shard_args = _tree_map_columns(
            _struct(lambda x: _shard_shape(x, ncol, n_dev)),
            _struct(lambda x: x.shape),
            args,
        )
        out_shapes = jax.eval_shape(fn, *shard_args)
        out_specs = jax.tree_util.tree_map(
            lambda x: _col_pspec(x, ncol_shard), out_shapes
        )
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(*args)

    return wrapped


def _shard_shape(x, ncol: int, n_dev: int):
    """Per-shard shape of a leaf under column sharding."""
    if x.ndim and x.shape[-1] == ncol:
        return (*x.shape[:-1], ncol // n_dev)
    return x.shape
