"""High-level solver API.

Mirrors the reference's L8 API surface (/root/reference/src/api/):
``RRTMGPGridParams`` + radiation-method types (api_types.jl:19-103), the
``RRTMGPSolver`` bundle + ``update_lw_fluxes!``/``update_sw_fluxes!``
(api.jl:34-176), the getter surface (getters.jl + api_methods.jl, list at
test/api_method_utils.jl:2-38), canonical aerosol/gas name lists
(api_methods.jl:49-141), and domain_view isothermal-boundary-layer handling
(api_methods.jl:17-42).

JAX adaptation: RRTMGPSolver is a thin HOST-side wrapper that owns pytree
state and jit-compiled pure solve functions; update_* methods run one solve
and store the resulting flux pytrees. The McICA reproducibility contract
(reset_rng_seed, api_types.jl:75-85) maps to counter-based keys derived from
the step number.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .data.lookups import AerosolLookup, CloudLookup, GasLookup
from .models import rrtmgp as _solvers
from .models.gray import GrayAtmosphericState, solve_gray_lw, solve_gray_sw
from .parameters import RRTMGPParameters
from .states import AtmosphericState, LwBCs, SwBCs


# ---------------------------------------------------------------------------
# Grid params + radiation methods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RRTMGPGridParams:
    """Grid configuration (ref api_types.jl:19-33)."""

    nlay: int
    ncol: int
    dtype: type = jnp.float32
    isothermal_boundary_layer: bool = False


@dataclasses.dataclass(frozen=True)
class GrayRadiation:
    pass


@dataclasses.dataclass(frozen=True)
class ClearSkyRadiation:
    aerosol_radiation: bool = False


@dataclasses.dataclass(frozen=True)
class AllSkyRadiation:
    aerosol_radiation: bool = False
    reset_rng_seed: bool = False


@dataclasses.dataclass(frozen=True)
class AllSkyRadiationWithClearSkyDiagnostics:
    aerosol_radiation: bool = False
    reset_rng_seed: bool = False


RadiationMethod = (
    GrayRadiation | ClearSkyRadiation | AllSkyRadiation | AllSkyRadiationWithClearSkyDiagnostics
)


# ---------------------------------------------------------------------------
# Lookup-table loading per radiation method
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LookupBundle:
    """Lookup set per radiation mode (ref ext/RRTMGPNCDatasetsExt.jl:15-89)."""

    lookup_lw: GasLookup | None = None
    lookup_sw: GasLookup | None = None
    lookup_lw_cld: CloudLookup | None = None
    lookup_sw_cld: CloudLookup | None = None
    lookup_lw_aero: AerosolLookup | None = None
    lookup_sw_aero: AerosolLookup | None = None


def lookup_tables(
    radiation_method: RadiationMethod,
    data_dir: str | None = None,
    dtype=None,
) -> LookupBundle:
    """Build the lookup set for a radiation method.

    With ``data_dir`` (or $RRTMGP_DATA) pointing at rrtmgp-data v1.9, loads
    the real NetCDF tables (ref ext/RRTMGPNCDatasetsExt.jl); otherwise builds
    structurally-faithful synthetic tables at real dimensions.
    """
    import os

    import numpy as np

    dtype = dtype or np.float64
    if isinstance(radiation_method, GrayRadiation):
        return LookupBundle()

    data_dir = data_dir or os.environ.get("RRTMGP_DATA")
    aero = getattr(radiation_method, "aerosol_radiation", False)
    cloudy = isinstance(
        radiation_method, (AllSkyRadiation, AllSkyRadiationWithClearSkyDiagnostics)
    )

    if data_dir:
        from .data.loader import load_aerosol_lookup, load_cloud_lookup, load_gas_lookup
        from .data.manifest import validate_rrtmgp_data

        # structural validation before first use: variables present, dim
        # names as expected, internal size relations consistent — a
        # malformed checkout fails loudly instead of scrambling a table
        validate_rrtmgp_data(data_dir, strict_v19=False)

        j = lambda name: os.path.join(data_dir, name)
        bundle = dict(
            lookup_lw=load_gas_lookup(j("rrtmgp-gas-lw-g256.nc"), dtype),
            lookup_sw=load_gas_lookup(j("rrtmgp-gas-sw-g224.nc"), dtype),
        )
        if cloudy:
            bundle["lookup_lw_cld"] = load_cloud_lookup(j("rrtmgp-clouds-lw-bnd.nc"), dtype)
            bundle["lookup_sw_cld"] = load_cloud_lookup(j("rrtmgp-clouds-sw-bnd.nc"), dtype)
        if aero:
            bundle["lookup_lw_aero"] = load_aerosol_lookup(j("rrtmgp-aerosols-merra-lw.nc"), dtype)
            bundle["lookup_sw_aero"] = load_aerosol_lookup(j("rrtmgp-aerosols-merra-sw.nc"), dtype)
        return LookupBundle(**bundle)

    from .data.synthetic import (
        synthetic_aerosol_lookup,
        synthetic_cloud_lookup,
        synthetic_gas_lookup,
    )

    bundle = dict(
        lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=256, n_bnd=16, dtype=dtype),
        lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=224, n_bnd=14, seed=1, dtype=dtype),
    )
    if cloudy:
        bundle["lookup_lw_cld"] = synthetic_cloud_lookup(n_bnd=16, dtype=dtype)
        bundle["lookup_sw_cld"] = synthetic_cloud_lookup(n_bnd=14, seed=5, dtype=dtype)
    if aero:
        bundle["lookup_lw_aero"] = synthetic_aerosol_lookup(n_bnd=16, dtype=dtype)
        bundle["lookup_sw_aero"] = synthetic_aerosol_lookup(n_bnd=14, seed=6, dtype=dtype)
    return LookupBundle(**bundle)


# ---------------------------------------------------------------------------
# Canonical name lists
# ---------------------------------------------------------------------------


def aerosol_names() -> list[str]:
    """Canonical MERRA aerosol-name set (ref api_methods.jl:49-65)."""
    return [
        "dust4", "sea_salt5", "dust1", "sulfate", "organic_carbon", "dust5",
        "sea_salt3", "sea_salt1", "organic_carbon_rh", "dust2", "sea_salt2",
        "sea_salt4", "dust3", "black_carbon_rh", "black_carbon",
    ]


#: aerosol name -> 0-based row in AerosolState.aero_mass/aero_size, matching
#: the reference's idx_aerosol map (ref ext/lookup_constructors.jl:22-33, 1-based)
AEROSOL_INDEX = {
    "dust1": 0, "sea_salt1": 1, "sulfate": 2, "black_carbon_rh": 3,
    "black_carbon": 4, "organic_carbon_rh": 5, "organic_carbon": 6,
    "dust2": 7, "dust3": 8, "dust4": 9, "dust5": 10,
    "sea_salt2": 11, "sea_salt3": 12, "sea_salt4": 13, "sea_salt5": 14,
}


def gas_names_sw() -> list[str]:
    """Gas names in the SW lookup tables (ref api_methods.jl:119-141)."""
    return [
        "h2o", "cfc11", "h2o_self", "co2", "cfc12", "hfc134a", "cfc22", "ch4",
        "hfc23", "ccl4", "hfc143a", "co", "no2", "n2", "o2", "o3", "h2o_frgn",
        "hfc32", "n2o", "cf4", "hfc125",
    ]


# ---------------------------------------------------------------------------
# f64 memory sizing
# ---------------------------------------------------------------------------

#: Device temporaries of the unchunked f64 pair per spectral element
#: (layer x column x g-point, g-points = the wider of LW and SW):
#: ``compiled.memory_analysis().temp_size_in_bytes / (ncol * nlay * ngpt)``
#: of the all-sky + aerosol pair, the largest f64 program (5.93e9 B at 4,096
#: columns x 60 layers x 256 g-points; the clear pair needs 4.74e9 B), from
#: XLA's GPU backend on an NVIDIA H100 80GB HBM3 at a 400 W power limit.
F64_BYTES_PER_ELEMENT = 94.3

#: Share of the device's ``bytes_limit`` an f64 solve may fill with
#: temporaries; the rest holds the state, the outputs and other programs.
CHUNK_BUDGET_FRACTION = 0.5


def f64_bytes_per_column(nlay: int, ngpt: int) -> float:
    """Device temporaries of the f64 pair per column (see F64_BYTES_PER_ELEMENT)."""
    return nlay * ngpt * F64_BYTES_PER_ELEMENT


def chunk_budget_bytes(device=None) -> float | None:
    """Bytes of temporaries one f64 solve may use.

    ``$RRTMGP_CHUNK_BUDGET_GB`` overrides; otherwise CHUNK_BUDGET_FRACTION of
    the device's ``memory_stats()["bytes_limit"]``. None when the device
    reports no limit (the CPU): the solve is then not chunked."""
    import os

    env = os.environ.get("RRTMGP_CHUNK_BUDGET_GB")
    if env:
        return float(env) * 1e9
    device = jax.devices()[0] if device is None else device
    limit = (device.memory_stats() or {}).get("bytes_limit")
    return CHUNK_BUDGET_FRACTION * limit if limit else None


def auto_chunk_size(ncol: int, per_col: float, budget: float | None) -> int | None:
    """Column chunk that keeps ``chunk * per_col`` within ``budget``, or None
    when the whole batch fits (or there is no budget).

    The chunk is a FREE choice: the chunked solve edge-pads columns up to a
    chunk multiple and slices back, so it need not divide ncol (a prime ncol
    would otherwise collapse to one column per step). The largest power of
    two <= the budget's column count divides typical column counts exactly
    and bounds pad waste."""
    if budget is None:
        return None
    cmax = max(int(budget // per_col), 1)
    if ncol <= cmax:
        return None
    return 1 << (cmax.bit_length() - 1)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class RRTMGPSolver:
    """Host-side solver bundle (ref api.jl:34-108).

    Owns the atmospheric state, BCs, lookup tables, and jitted solve
    functions; ``update_lw_fluxes``/``update_sw_fluxes`` run one solve and
    store the flux pytrees for the getter surface.
    """

    def __init__(
        self,
        grid_params: RRTMGPGridParams,
        radiation_method: RadiationMethod,
        params: RRTMGPParameters,
        bcs_lw: LwBCs | None,
        bcs_sw: SwBCs | None,
        as_: AtmosphericState | GrayAtmosphericState,
        lookups: LookupBundle | None = None,
        center_z=None,
        face_z=None,
        two_stream_lw: bool = True,
        two_stream_sw: bool = True,
        n_gauss_angles: int = 1,
        data_dir: str | None = None,
        aero_species: tuple | None = None,
        mesh=None,
        metric_scaling=None,
        eta_node_mode: str = "continuous",
    ):
        self.grid_params = grid_params
        self.radiation_method = radiation_method
        self.params = params
        self.bcs_lw = bcs_lw
        self.bcs_sw = bcs_sw
        self.as_ = as_
        # fail construction on a state/grid dtype mismatch: mixed f32/f64
        # pytrees otherwise surface as inscrutable scan carry-dtype errors
        # deep inside the solve (and under jax_enable_x64 a default-dtype
        # synthetic state is f64 while grid_params may say f32)
        want = jnp.dtype(grid_params.dtype)
        got = jnp.dtype(as_.p_lay.dtype)
        if got != want:
            raise TypeError(
                f"AtmosphericState dtype {got} != grid_params dtype {want}; "
                "build the state with the grid dtype (e.g. "
                "synthetic_atmosphere(dtype=...), setup_gray_as_pr_grid"
                "(dtype=...))"
            )
        self.center_z = center_z
        self.face_z = face_z
        self.two_stream_lw = two_stream_lw
        self.two_stream_sw = two_stream_sw
        # LW no-scat Gauss-Jacobi-5 quadrature order (1-4); the reference
        # carries AngularDiscretization in its solver container
        # (/root/reference/src/optics/RTE.jl:61-70) but runs angle 1; here
        # n_gauss_angles > 1 sums the no-scat sweep over the quadrature.
        # Ignored by two-stream LW and by SW (as in the reference). Each
        # extra angle re-runs the no-scat sweep over the same optics.
        self.n_gauss_angles = n_gauss_angles
        # Multi-device: a 1-D jax.sharding.Mesh over the column axis
        # (parallel.sharding.make_column_mesh). The solves are shard_mapped —
        # each device runs the same program on its local columns, tables
        # replicated, zero collectives; McICA streams are keyed on GLOBAL
        # column indices so results are bitwise mesh-layout-invariant. ncol
        # must divide by the mesh size.
        self.mesh = mesh
        # optional (nlev, ncol) deep-atmosphere metric scaling applied to all
        # fluxes (ref Fluxes.jl:227-236; solver-arg in RTESolver.jl)
        self.metric_scaling = metric_scaling
        # optional STATIC declaration of the MERRA aerosol species the host
        # loads (indices into api_methods-style aerosol_names order); species
        # outside the set are skipped at trace time. None = all 15.
        self.aero_species = aero_species
        # eta grid-node semantics (ops.gas_optics.ETA_NODE_MODES): default
        # "continuous" (node-continuous interpolation); "reference" reproduces
        # the reference's full-cell jump at exact eta nodes — REQUIRED for
        # golden parity runs against the Fortran reference fluxes.
        self.eta_node_mode = eta_node_mode
        if lookups is None:
            import numpy as np

            np_dtype = np.dtype(jnp.dtype(grid_params.dtype)).type
            lookups = lookup_tables(radiation_method, data_dir=data_dir, dtype=np_dtype)
        self.lookups = lookups

        self.flux_lw: _solvers.FluxLW | None = None
        self.flux_sw: _solvers.FluxSW | None = None
        self.clear_flux_lw: _solvers.FluxLW | None = None
        self.clear_flux_sw: _solvers.FluxSW | None = None
        self.diag_lw: _solvers.SolveDiagnostics | None = None
        self.diag_sw: _solvers.SolveDiagnostics | None = None
        #: f64 auto-chunk size (None = unchunked); set by _build_solvers for
        #: non-gray f64 solvers above the memory budget. Initialized here so
        #: every solver (incl. gray, whose _build_solvers returns early)
        #: exposes the attribute.
        self.auto_chunk: int | None = None
        self._step = 0
        self._build_solvers()

    # -- construction of jitted pure functions ------------------------------

    def _build_solvers(self):
        m = self.radiation_method
        lk = self.lookups
        gray = isinstance(m, GrayRadiation)
        cloudy = isinstance(m, (AllSkyRadiation, AllSkyRadiationWithClearSkyDiagnostics))
        aero = getattr(m, "aerosol_radiation", False)

        if gray:
            self._lw_fn = jax.jit(
                partial(solve_gray_lw, params=self.params,
                        two_stream=self.two_stream_lw,
                        n_gauss_angles=self.n_gauss_angles)
            )
            self._sw_fn = jax.jit(partial(solve_gray_sw, two_stream=self.two_stream_sw))
            return

        lw_aero = lk.lookup_lw_aero if aero else None
        sw_aero = lk.lookup_sw_aero if aero else None
        aspec = self.aero_species
        mscale = self.metric_scaling
        ncol0 = int(self.as_.ncol)
        mesh = self.mesh

        # f64 auto-chunking: the XLA path materializes (nlay, ncol, ngpt)
        # spectral tensors, so a solve above the memory budget routes through
        # solve_chunked automatically and DYAMOND-scale f64 runs work
        # unmodified (the reference runs f64 first-class,
        # /root/reference/test/runtests.jl:27-30). McICA stays bitwise
        # chunk-invariant (global-column keying, solve_chunked contract).
        dt = jnp.dtype(self.grid_params.dtype)
        if mesh is None and dt == jnp.float64:
            import warnings as _warnings

            ngpt_max = max(lk.lookup_lw.n_gpt, lk.lookup_sw.n_gpt)
            per_col = f64_bytes_per_column(self.as_.nlay, ngpt_max)
            budget = chunk_budget_bytes()
            self.auto_chunk = auto_chunk_size(ncol0, per_col, budget)
            if self.auto_chunk is not None:
                _warnings.warn(
                    f"f64 solve at ncol={ncol0} needs ~{ncol0 * per_col / 1e9:.1f}"
                    f" GB of device temporaries; auto-chunking into "
                    f"{self.auto_chunk}-column chunks (budget "
                    f"{budget / 1e9:.1f} GB, $RRTMGP_CHUNK_BUDGET_GB to adjust)",
                    stacklevel=3,
                )
        chunk = self.auto_chunk
        #: global column ids, sharded alongside the state in mesh mode; the
        #: cloudy solves read col_ids[0] = the shard's global column offset
        self._col_ids = jnp.arange(ncol0, dtype=jnp.int32)

        def _spmd(fn):
            """jit; in mesh mode, shard_map over the column mesh first."""
            if mesh is not None:
                from .parallel.sharding import shard_solve

                fn = shard_solve(fn, mesh, ncol0)
            return jax.jit(fn)

        nga = self.n_gauss_angles
        enm = self.eta_node_mode

        def lw_clear_one(atm, bcs):
            return _solvers.solve_lw(
                lk.lookup_lw, atm, bcs, two_stream=self.two_stream_lw, lkp_aero=lw_aero,
                n_gauss_angles=nga,
                aero_species=aspec, metric_scaling=mscale,
                eta_node_mode=enm,
            )

        def sw_clear_one(atm, bcs):
            return _solvers.solve_sw(
                lk.lookup_sw, atm, bcs, two_stream=self.two_stream_sw, lkp_aero=sw_aero,
                aero_species=aspec, metric_scaling=mscale,
                eta_node_mode=enm,
            )

        def _chunked(one_fn, atm, bcs, **kw):
            # auto_chunk need not divide the column count (it is budget-
            # derived, not a divisor of ncol): edge-pad columns to a chunk
            # multiple and slice back. In seed mode the pad columns' McICA
            # offsets run past ncol, which is inert — their fluxes are sliced
            # away. pad/slice_columns are no-ops when chunk divides ncol.
            nc = atm.ncol
            atm_p = _solvers.pad_columns(atm, nc, multiple=chunk)
            bcs_p = _solvers.pad_columns(bcs, nc, multiple=chunk)
            out = _solvers.solve_chunked(one_fn, atm_p, bcs_p, chunk, **kw)
            return _solvers.slice_columns(out, nc, multiple=chunk)

        def lw_clear(atm, bcs):
            if chunk is not None:
                return _chunked(lw_clear_one, atm, bcs)
            return lw_clear_one(atm, bcs)

        def sw_clear(atm, bcs):
            if chunk is not None:
                return _chunked(sw_clear_one, atm, bcs)
            return sw_clear_one(atm, bcs)

        self._lw_clear = _spmd(lw_clear)
        self._sw_clear = _spmd(sw_clear)

        # fused LW+SW pair: ONE jitted program per radiation step, so the
        # separate update_lw/update_sw jits' host dispatch gap between them
        # is not paid; update_fluxes() uses these
        def pair_clear(atm, bl, bs):
            return lw_clear(atm, bl), sw_clear(atm, bs)

        self._pair_clear = _spmd(pair_clear)

        if cloudy:

            def lw_cloudy_one(atm, bcs, seed, col_off):
                return _solvers.solve_lw(
                    lk.lookup_lw, atm, bcs, two_stream=self.two_stream_lw,
                    n_gauss_angles=nga,
                    lkp_cld=lk.lookup_lw_cld, lkp_aero=lw_aero,
                    cld_mask_seed=seed, col_offset=col_off,
                    aero_species=aspec, metric_scaling=mscale,
                    eta_node_mode=enm,
                )

            def sw_cloudy_one(atm, bcs, seed, col_off):
                return _solvers.solve_sw(
                    lk.lookup_sw, atm, bcs, two_stream=self.two_stream_sw,
                    lkp_cld=lk.lookup_sw_cld, lkp_aero=sw_aero,
                    cld_mask_seed=seed, col_offset=col_off,
                    aero_species=aspec, metric_scaling=mscale,
                    eta_node_mode=enm,
                )

            def lw_cloudy(atm, bcs, seed, col_ids):
                if chunk is not None:
                    # per-chunk GLOBAL offsets = batch base + chunk offset:
                    # the McICA stream stays bitwise chunk-invariant
                    return _chunked(
                        lambda a, b, s, off: lw_cloudy_one(a, b, s, col_ids[0] + off),
                        atm, bcs, cld_mask_seed=seed,
                    )
                return lw_cloudy_one(atm, bcs, seed, col_ids[0])

            def sw_cloudy(atm, bcs, seed, col_ids):
                if chunk is not None:
                    return _chunked(
                        lambda a, b, s, off: sw_cloudy_one(a, b, s, col_ids[0] + off),
                        atm, bcs, cld_mask_seed=seed,
                    )
                return sw_cloudy_one(atm, bcs, seed, col_ids[0])

            self._lw_cloudy = _spmd(lw_cloudy)
            self._sw_cloudy = _spmd(sw_cloudy)

            def pair_cloudy(atm, bl, bs, seed_lw, seed_sw, col_ids):
                return (
                    lw_cloudy(atm, bl, seed_lw, col_ids),
                    sw_cloudy(atm, bs, seed_sw, col_ids),
                )

            self._pair_cloudy = _spmd(pair_cloudy)

    def _mcica_key(self, wave: int):
        """Counter-based seed derived from the step number: the reset_rng_seed
        reproducibility contract (ref api_types.jl:75-85) holds by
        construction — setting the same step reproduces the same McICA
        sampling bitwise."""
        return jnp.asarray(2 * self._step + wave, jnp.int32)

    def advance_step(self, step: int | None = None):
        """Advance (or set) the timestep used for McICA keys."""
        self._step = self._step + 1 if step is None else step

    # -- flux updates (ref api.jl:115-176) ----------------------------------

    def update_fluxes(self):
        """Update LW AND SW fluxes in ONE jitted program.

        Functionally identical to update_lw_fluxes() + update_sw_fluxes()
        (same solves, same McICA keys), but the pair runs as a single jit —
        removing the host dispatch gap between the two separate jits, which
        matters at small per-device batches. Returns (flux_lw, flux_sw). The
        reference has no combined method (hosts call
        update_lw_fluxes!/update_sw_fluxes! separately, ref api.jl:115-176).
        """
        m = self.radiation_method
        if isinstance(m, GrayRadiation) or self.bcs_lw is None or self.bcs_sw is None:
            # gray / partial-BC solvers run the two updates separately
            self.update_lw_fluxes()
            self.update_sw_fluxes()
            return self.flux_lw, self.flux_sw
        if isinstance(m, ClearSkyRadiation):
            (self.flux_lw, self.diag_lw), (self.flux_sw, self.diag_sw) = (
                self._pair_clear(self.as_, self.bcs_lw, self.bcs_sw)
            )
        elif isinstance(m, AllSkyRadiation):
            (self.flux_lw, self.diag_lw), (self.flux_sw, self.diag_sw) = (
                self._pair_cloudy(
                    self.as_, self.bcs_lw, self.bcs_sw,
                    self._mcica_key(0), self._mcica_key(1), self._col_ids,
                )
            )
        elif isinstance(m, AllSkyRadiationWithClearSkyDiagnostics):
            (self.clear_flux_lw, _), (self.clear_flux_sw, _) = (
                self._pair_clear(self.as_, self.bcs_lw, self.bcs_sw)
            )
            (self.flux_lw, self.diag_lw), (self.flux_sw, self.diag_sw) = (
                self._pair_cloudy(
                    self.as_, self.bcs_lw, self.bcs_sw,
                    self._mcica_key(0), self._mcica_key(1), self._col_ids,
                )
            )
        return self.flux_lw, self.flux_sw

    def lower_update_fluxes(self) -> jax.stages.Lowered:
        """The fused LW+SW program update_fluxes() runs for ClearSkyRadiation
        or AllSkyRadiation, lowered for the current state: ``.compile()``
        gives its compile time and ``memory_analysis()``."""
        m = self.radiation_method
        if type(m) is ClearSkyRadiation:
            return self._pair_clear.lower(self.as_, self.bcs_lw, self.bcs_sw)
        if type(m) is AllSkyRadiation:
            return self._pair_cloudy.lower(
                self.as_, self.bcs_lw, self.bcs_sw,
                self._mcica_key(0), self._mcica_key(1), self._col_ids,
            )
        raise TypeError(f"update_fluxes runs more than one program for {m!r}")

    def update_lw_fluxes(self):
        m = self.radiation_method
        if isinstance(m, GrayRadiation):
            up, dn, net = self._lw_fn(self.as_, self.bcs_lw.sfc_emis[0])
            self.flux_lw = _solvers.FluxLW(up, dn, net)
        elif isinstance(m, ClearSkyRadiation):
            self.flux_lw, self.diag_lw = self._lw_clear(self.as_, self.bcs_lw)
        elif isinstance(m, AllSkyRadiation):
            self.flux_lw, self.diag_lw = self._lw_cloudy(
                self.as_, self.bcs_lw, self._mcica_key(0), self._col_ids
            )
        elif isinstance(m, AllSkyRadiationWithClearSkyDiagnostics):
            self.clear_flux_lw, _ = self._lw_clear(self.as_, self.bcs_lw)
            self.flux_lw, self.diag_lw = self._lw_cloudy(
                self.as_, self.bcs_lw, self._mcica_key(0), self._col_ids
            )
        return self.flux_lw

    def update_sw_fluxes(self):
        m = self.radiation_method
        if isinstance(m, GrayRadiation):
            up, dn, dn_dir, net = self._sw_fn(
                self.as_,
                self.bcs_sw.cos_zenith,
                self.bcs_sw.toa_flux,
                self.bcs_sw.sfc_alb_direct[0],
                self.bcs_sw.sfc_alb_diffuse[0],
            )
            self.flux_sw = _solvers.FluxSW(up, dn, dn_dir, net)
        elif isinstance(m, ClearSkyRadiation):
            self.flux_sw, self.diag_sw = self._sw_clear(self.as_, self.bcs_sw)
        elif isinstance(m, AllSkyRadiation):
            self.flux_sw, self.diag_sw = self._sw_cloudy(
                self.as_, self.bcs_sw, self._mcica_key(1), self._col_ids
            )
        elif isinstance(m, AllSkyRadiationWithClearSkyDiagnostics):
            self.clear_flux_sw, _ = self._sw_clear(self.as_, self.bcs_sw)
            self.flux_sw, self.diag_sw = self._sw_cloudy(
                self.as_, self.bcs_sw, self._mcica_key(1), self._col_ids
            )
        return self.flux_sw

    # -- getter surface (ref api_methods.jl + getters.jl) -------------------

    def top_of_atmosphere_lw_flux_dn(self):
        return None if self.bcs_lw is None else self.bcs_lw.inc_flux

    def top_of_atmosphere_diffuse_sw_flux_dn(self):
        return None if self.bcs_sw is None else self.bcs_sw.inc_flux_diffuse

    def lw_flux_up(self):
        return self.flux_lw.flux_up

    def lw_flux_dn(self):
        return self.flux_lw.flux_dn

    def lw_flux_net(self):
        return self.flux_lw.flux_net

    def clear_lw_flux_up(self):
        return self.clear_flux_lw.flux_up

    def clear_lw_flux_dn(self):
        return self.clear_flux_lw.flux_dn

    def clear_lw_flux(self):
        return self.clear_flux_lw.flux_net

    def surface_emissivity(self):
        return self.bcs_lw.sfc_emis

    def sw_flux_up(self):
        return self.flux_sw.flux_up

    def sw_flux_dn(self):
        return self.flux_sw.flux_dn

    def sw_flux_net(self):
        return self.flux_sw.flux_net

    def sw_direct_flux_dn(self):
        return self.flux_sw.flux_dn_dir

    def clear_sw_flux_up(self):
        return self.clear_flux_sw.flux_up

    def clear_sw_flux_dn(self):
        return self.clear_flux_sw.flux_dn

    def clear_sw_direct_flux_dn(self):
        return self.clear_flux_sw.flux_dn_dir

    def clear_sw_flux(self):
        return self.clear_flux_sw.flux_net

    def cloud_liquid_effective_radius(self):
        return self.as_.cloud_state.cld_r_eff_liq

    def cloud_ice_effective_radius(self):
        return self.as_.cloud_state.cld_r_eff_ice

    def cloud_liquid_water_path(self):
        return self.as_.cloud_state.cld_path_liq

    def cloud_ice_water_path(self):
        return self.as_.cloud_state.cld_path_ice

    def cloud_fraction(self):
        return self.as_.cloud_state.cld_frac

    def sw_cloud_cover(self):
        return None if self.diag_sw is None else self.diag_sw.cld_cover

    def lw_cloud_cover(self):
        return None if self.diag_lw is None else self.diag_lw.cld_cover

    def aod_sw_extinction(self):
        return None if self.diag_sw is None else self.diag_sw.aod_sw_ext

    def aod_sw_scattering(self):
        return None if self.diag_sw is None else self.diag_sw.aod_sw_sca

    def get_center_z(self):
        """Cell-center heights, as provided by the host (ref getters.jl:44)."""
        return self.center_z

    def get_face_z(self):
        """Cell-face heights, as provided by the host (ref getters.jl:45)."""
        return self.face_z

    def cos_zenith(self):
        return self.bcs_sw.cos_zenith

    def toa_flux(self):
        return self.bcs_sw.toa_flux

    def direct_sw_surface_albedo(self):
        return self.bcs_sw.sfc_alb_direct

    def diffuse_sw_surface_albedo(self):
        return self.bcs_sw.sfc_alb_diffuse

    def latitude(self):
        return self.as_.lat

    def surface_temperature(self):
        return self.as_.t_sfc

    def domain_view(self, data):
        """View of ``data`` restricted to the physical domain: drops the
        isothermal boundary layer (the TOP layer; vertical axis leading,
        level 0 = surface) when the grid declares one
        (ref api_methods.jl:17-42)."""
        if data is None:
            return None
        return domain_view(self.grid_params.isothermal_boundary_layer, data)

    def pressure(self):
        return self.domain_view(self.as_.p_lay)

    def temperature(self):
        return self.domain_view(self.as_.t_lay)

    def relative_humidity(self):
        return self.domain_view(getattr(self.as_, "rel_hum", None))

    def optical_thickness_parameter(self):
        return getattr(self.as_, "otp", None)

    def isothermal_boundary_layer(self) -> bool:
        return self.grid_params.isothermal_boundary_layer

    def aero_radius(self, name: str):
        """Aerosol size for ``name`` (ref api_methods.jl:70-81)."""
        return self.as_.aerosol_state.aero_size[AEROSOL_INDEX[name]]

    def aero_column_mass_density(self, name: str):
        return self.as_.aerosol_state.aero_mass[AEROSOL_INDEX[name]]

    def volume_mixing_ratio(self, name: str):
        """VMR by gas name via the SW gas-name index (ref api_methods.jl:143-155)."""
        from .states import get_vmr

        names = list(self.lookups.lookup_sw.gas_names) if self.lookups.lookup_sw else gas_names_sw()
        aliases = {"h2o_self": "h2o", "h2o_frgn": "h2o"}
        name = aliases.get(name, name)
        return get_vmr(self.as_.vmr, names.index(name) + 1)


def domain_view(isothermal_boundary_layer: bool, data):
    """Exclude the isothermal boundary layer (top layer/level) if present
    (ref api_methods.jl:17-42). Vertical axis leading."""
    if not isothermal_boundary_layer:
        return data
    return data[:-1]
