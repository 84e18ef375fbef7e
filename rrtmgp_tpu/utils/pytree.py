"""Pytree dataclass helper.

The reference (RRTMGP.jl) uses mutable structs adapted for GPU capture via
``Adapt.@adapt_structure`` (e.g. /root/reference/src/optics/AtmosphericStates.jl:58).
Here it is an immutable dataclass registered as a JAX pytree:
fields flow through ``jit``/``grad``/``shard_map`` as leaves, while static
(configuration) fields are hashable aux data.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

_T = TypeVar("_T")


def pytree_dataclass(cls: type[_T] | None = None, *, meta_fields: tuple[str, ...] = ()):
    """Decorator: frozen dataclass registered as a JAX pytree.

    ``meta_fields`` are static (hashable) and become part of the treedef;
    all other fields are traced array leaves.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(f.name for f in dataclasses.fields(c) if f.name not in meta_fields)
        jax.tree_util.register_dataclass(c, data_fields=data_fields, meta_fields=meta_fields)
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def replace(obj: _T, **changes) -> _T:
    """Functional update of a pytree dataclass (the analogue of in-place mutation)."""
    return dataclasses.replace(obj, **changes)
