"""Static package hygiene — the Aqua.jl analogue (ref test/aqua.jl:5-34).

Aqua checks unbound type parameters, method ambiguities, stale deps, and
piracy; the Python equivalents here: every module imports cleanly (no import
cycles / missing deps), the public API surface resolves and is callable, no
module accidentally shadows a stdlib name, and pytree dataclasses
round-trip flatten/unflatten (the analogue of Adapt-ability).
"""

import importlib
import pkgutil

import jax
import numpy as np
import pytest

import rrtmgp_tpu


def _all_modules():
    mods = []
    for m in pkgutil.walk_packages(rrtmgp_tpu.__path__, prefix="rrtmgp_tpu."):
        mods.append(m.name)
    return mods


def test_all_modules_import():
    for name in _all_modules():
        importlib.import_module(name)


def test_public_api_resolves():
    """Everything reachable as rrtmgp_tpu.<name> is a real object; the
    canonical entry points exist and are callable."""
    for name in dir(rrtmgp_tpu):
        if not name.startswith("_"):
            assert getattr(rrtmgp_tpu, name) is not None
    for fn in (
        "solve_lw", "solve_sw", "solve_chunked",
        "solve_gray_lw", "solve_gray_sw", "gray_lw_equilibrium",
        "setup_gray_as_pr_grid", "lookup_tables", "domain_view",
        "aerosol_names", "gas_names_sw",
    ):
        assert callable(getattr(rrtmgp_tpu, fn)), fn
    for cls in (
        "RRTMGPSolver", "RRTMGPGridParams", "RRTMGPParameters",
        "GrayRadiation", "ClearSkyRadiation", "AllSkyRadiation",
        "AllSkyRadiationWithClearSkyDiagnostics", "LookupBundle",
        "AtmosphericState", "CloudState", "AerosolState", "LwBCs", "SwBCs",
        "FluxLW", "FluxSW",
    ):
        assert isinstance(getattr(rrtmgp_tpu, cls), type), cls


def test_pytree_dataclasses_roundtrip():
    """State/lookup pytrees flatten/unflatten losslessly with static
    metadata preserved (the Adapt.adapt_structure analogue)."""
    from rrtmgp_tpu.data.synthetic import (
        synthetic_aerosol_lookup,
        synthetic_atmosphere,
        synthetic_cloud_lookup,
        synthetic_gas_lookup,
    )

    trees = [
        synthetic_gas_lookup(longwave=True, n_gpt=16, n_bnd=2),
        synthetic_gas_lookup(longwave=False, n_gpt=16, n_bnd=2, seed=1),
        synthetic_cloud_lookup(n_bnd=2),
        synthetic_aerosol_lookup(n_bnd=2),
        synthetic_atmosphere(ncol=4, nlay=6, with_clouds=True, with_aerosols=True),
    ]
    for t in trees:
        leaves, treedef = jax.tree_util.tree_flatten(t)
        t2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert jax.tree_util.tree_structure(t2) == treedef
        for a, b in zip(leaves, jax.tree_util.tree_leaves(t2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # hashable static metadata (required for jit static args)
        hash(treedef)


def test_no_stdlib_shadowing():
    import sys

    stdlib = set(sys.stdlib_module_names)
    for name in _all_modules():
        leaf = name.rsplit(".", 1)[-1]
        # module FILES may share stdlib names only if unambiguous under
        # absolute imports (they live in the package namespace); top-level
        # package must not shadow
        assert name.split(".")[0] not in stdlib
        if leaf in stdlib:
            # ensure 'import <leaf>' still resolves to the stdlib module
            mod = importlib.import_module(leaf)
            assert "rrtmgp_tpu" not in (getattr(mod, "__file__", "") or ""), name
