"""Full-physics RRTMGP radiation solvers (clear-sky / cloudy / all-sky).

The counterpart of the reference's solver dispatch + outer loops
(/root/reference/src/rte/RTESolver.jl and rte_*_solve! drivers in
/root/reference/src/rte/*.jl). Control flow is restructured:

- The reference loops g-points serially (bounding memory with one temp flux
  buffer) and columns in parallel. Here ALL g-points solve in one batched
  program: optics (nlay, ncol, ngpt) -> RTE with batch (ncol, ngpt) ->
  g-point reduction is a lane-axis sum. At large ncol, memory is bounded by
  sharding/chunking columns (the natural parallel axis), not by serializing
  the spectrum.
- Band-dependent quantities (cloud/aerosol optical properties, surface
  emissivity/albedo) are computed at band granularity and expanded to
  g-points with one static band->gpt take along the trailing axis.
- Cloud McICA masks are sampled for ALL g-points at once with counter-based
  keys (ops/cloud_optics.build_cloud_mask_mcica), not per-g-point host RNG.

All functions are pure; fluxes are (nlay+1, ncol), level 0 = surface.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..angular import angular_discretization
from ..data.lookups import AerosolLookup, CloudLookup, GasLookup
from ..ops import rte
from ..ops.aerosol_optics import aerosol_optics_bands
from ..ops.cloud_optics import (
    cloud_optics_bands,
    delta_scale,
    increment_2stream,
)
from ..ops.gas_optics import gas_optics_lw, gas_optics_sw, gpt2band_np
from ..states import AtmosphericState, LwBCs, SwBCs, tree_map_columns as _tree_map_columns


class FluxLW(NamedTuple):
    flux_up: jax.Array   # (nlev, ncol)
    flux_dn: jax.Array
    flux_net: jax.Array


class FluxSW(NamedTuple):
    flux_up: jax.Array
    flux_dn: jax.Array
    flux_dn_dir: jax.Array
    flux_net: jax.Array


class SolveDiagnostics(NamedTuple):
    cld_cover: jax.Array | None = None  # (ncol,) McICA effective cloud cover
    aod_sw_ext: jax.Array | None = None # (ncol,) aerosol optical depth at 550nm
    aod_sw_sca: jax.Array | None = None


def pad_columns(pytree, ncol: int, multiple: int):
    """Edge-replicate-pad every column leaf (trailing axis ``ncol``) up to the
    next multiple of ``multiple``. Edge replication duplicates real columns,
    so the padded columns stay inside the lookup tables' ranges. No-op when
    already aligned."""
    npad = -(-ncol // multiple) * multiple
    if npad == ncol:
        return pytree

    def pad_leaf(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != ncol:
            return x
        widths = [(0, 0)] * (x.ndim - 1) + [(0, npad - ncol)]
        return jnp.pad(x, widths, mode="edge")

    return _tree_map_columns(pad_leaf, lambda x: x, pytree)


def slice_columns(pytree, ncol: int, multiple: int):
    """Undo ``pad_columns`` on outputs: slice trailing padded axes to ncol."""
    npad = -(-ncol // multiple) * multiple
    if npad == ncol:
        return pytree

    def slice_leaf(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != npad:
            return x
        return x[..., :ncol]

    return _tree_map_columns(slice_leaf, lambda x: x, pytree)


def solve_chunked(solve_fn, as_: AtmosphericState, bcs, chunk: int, *,
                  cld_mask=None, cld_mask_seed=None):
    """Run a solve over column chunks sequentially (lax.map) to bound memory.

    The reference bounds memory by serializing the g-point loop with one flux
    temp buffer (/root/reference/src/optics/RTE.jl:47); here the COLUMN
    chunks are serialized — the embarrassingly parallel axis — keeping the
    full spectrum batched on the device. ncol must be a multiple of
    ``chunk`` (pad upstream). cld_mask, when given, is chunked too.

    solve_fn: (atm_chunk, bcs_chunk[, cld_mask_chunk | seed, col_offset]) ->
    flux namedtuple. In seed mode solve_fn receives the (replicated) seed AND
    the chunk's global column offset — forward both to solve_lw/solve_sw
    (cld_mask_seed=seed, col_offset=off) so the McICA sample equals the
    unchunked one bitwise. Returns the flux namedtuple with columns
    re-concatenated.
    """
    ncol = as_.ncol
    assert ncol % chunk == 0, (ncol, chunk)
    n_chunks = ncol // chunk

    def chunk_rep(x):
        # replicated leaf (e.g. global-mean vmr vector): broadcast over chunks
        if x is None or not hasattr(x, "ndim"):
            return x
        return jnp.broadcast_to(x[None], (n_chunks, *x.shape))

    def chunk_leaf(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != ncol:
            return chunk_rep(x)
        return jnp.moveaxis(x.reshape(*x.shape[:-1], n_chunks, chunk), -2, 0)

    as_c = _tree_map_columns(chunk_leaf, chunk_rep, as_)
    bcs_c = _tree_map_columns(chunk_leaf, chunk_rep, bcs)

    if cld_mask is not None:
        # (nlay, ncol, ngpt): chunk the middle axis
        m = cld_mask.reshape(cld_mask.shape[0], n_chunks, chunk, cld_mask.shape[-1])
        m = jnp.moveaxis(m, 1, 0)
        fluxes = jax.lax.map(lambda args: solve_fn(*args), (as_c, bcs_c, m))
    elif cld_mask_seed is not None:
        # one shared seed + per-chunk GLOBAL column offsets: each chunk's
        # McICA stream is keyed on (seed, global column/block), so chunked
        # == unchunked bitwise (and chunks stay decorrelated)
        seeds = jnp.broadcast_to(
            jnp.asarray(cld_mask_seed, jnp.int32), (n_chunks,)
        )
        offs = jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(chunk)
        fluxes = jax.lax.map(lambda args: solve_fn(*args), (as_c, bcs_c, seeds, offs))
    else:
        fluxes = jax.lax.map(lambda args: solve_fn(*args), (as_c, bcs_c))

    def unchunk(x):  # (n_chunks, nlev, chunk) -> (nlev, ncol)
        return jnp.moveaxis(x, 0, -2).reshape(*x.shape[1:-1], ncol)

    return jax.tree_util.tree_map(unchunk, fluxes)


def _bands_to_gpt(lkp: GasLookup, x_bands: jax.Array) -> jax.Array:
    """Expand a per-band array (..., nbnd) to per-g-point (..., ngpt)."""
    return jnp.take(x_bands, jnp.asarray(gpt2band_np(lkp)), axis=-1)


def _apply_metric_scaling(flux, metric_scaling):
    """Deep-atmosphere metric scaling (ref /root/reference/src/optics/Fluxes.jl:227-236)."""
    if metric_scaling is None:
        return flux
    return type(flux)(*(f * metric_scaling for f in flux))


def _add_cloud_all(lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, delta_scaling):
    """Cloud optics per band, expanded to g-points, incremented under mask.

    1-scalar path (ssa None) adds absorption only (ref cloud_optics.jl:44);
    2-stream uses increment_2stream (ref cloud_optics.jl:115-124).
    cld_mask: (nlay, ncol, ngpt) bool.
    """
    cs = as_.cloud_state
    tau_b, ssa_b, g_b = cloud_optics_bands(lkp_cld, cs)  # (nlay, ncol, nbnd)
    tau_c = _bands_to_gpt(lkp, tau_b)                    # (nlay, ncol, ngpt)
    ssa_c = _bands_to_gpt(lkp, ssa_b)
    g_c = _bands_to_gpt(lkp, g_b)
    if ssa is None:
        return tau + jnp.where(cld_mask, tau_c - ssa_c * tau_c, 0.0), None, None
    if delta_scaling:
        tau_c, ssa_c, g_c = delta_scale(tau_c, ssa_c, g_c)
    tn, sn, gn = increment_2stream(tau, ssa, g_asym, tau_c, ssa_c, g_c)
    return (
        jnp.where(cld_mask, tn, tau),
        jnp.where(cld_mask, sn, ssa),
        jnp.where(cld_mask, gn, g_asym),
    )


def _add_aerosol_all(lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling,
                     collect_aod, active_species=None):
    """Aerosol optics per band, expanded to g-points (ref aerosol_optics.jl)."""
    eps = float(jnp.finfo(tau.dtype).eps)
    aero = as_.aerosol_state
    active = jnp.any(aero.aero_mass > 0.0, axis=0)  # (nlay, ncol)

    t_b, ts_b, tsg_b = aerosol_optics_bands(
        lkp_aero, aero, as_.rel_hum, active_species
    )
    t_b = jnp.where(active[..., None], t_b, 0.0)
    ts_b = jnp.where(active[..., None], ts_b, 0.0)
    tsg_b = jnp.where(active[..., None], tsg_b, 0.0)

    aod_ext = aod_sca = None
    if collect_aod and lkp_aero.iband_550nm >= 0:
        aod_ext = jnp.sum(t_b[:, :, lkp_aero.iband_550nm], axis=0)
        aod_sca = jnp.sum(ts_b[:, :, lkp_aero.iband_550nm], axis=0)

    t_a = _bands_to_gpt(lkp, t_b)
    ts_a = _bands_to_gpt(lkp, ts_b)
    tsg_a = _bands_to_gpt(lkp, tsg_b)

    if ssa is None:
        return tau + (t_a - ts_a), None, None, aod_ext, aod_sca

    g_a = tsg_a / jnp.maximum(eps, ts_a)
    ssa_a = ts_a / jnp.maximum(eps, t_a)
    if delta_scaling:
        t_a, ssa_a, g_a = delta_scale(t_a, ssa_a, g_a)
    tn, sn, gn = increment_2stream(tau, ssa, g_asym, t_a, ssa_a, g_a)
    m = active[..., None]
    return (
        jnp.where(m, tn, tau),
        jnp.where(m, sn, ssa),
        jnp.where(m, gn, g_asym),
        aod_ext,
        aod_sca,
    )


def _mcica_mask(lkp, lkp_cld, as_, cld_mask, cld_mask_seed, col_offset):
    """The McICA mask a solve uses: ``cld_mask`` as given, else one sampled
    from ``cld_mask_seed`` keyed on GLOBAL columns (threefry, counter-based),
    else None (clear sky)."""
    if cld_mask is None and cld_mask_seed is not None and lkp_cld is not None:
        from ..ops.cloud_optics import build_cloud_mask_mcica

        cld_mask = build_cloud_mask_mcica(
            jax.random.key(cld_mask_seed), as_.cloud_state.cld_frac, lkp.n_gpt,
            col_offset=col_offset,
        )
    return cld_mask


def _cloud_diag(diag: SolveDiagnostics, cld_mask, dtype) -> SolveDiagnostics:
    if cld_mask is None:
        return diag
    from ..ops.cloud_optics import cloud_cover_from_mask

    return diag._replace(cld_cover=cloud_cover_from_mask(cld_mask).astype(dtype))


def solve_lw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: LwBCs,
    *,
    two_stream: bool = False,
    n_gauss_angles: int = 1,
    lkp_cld: CloudLookup | None = None,
    lkp_aero: AerosolLookup | None = None,
    cld_mask: jax.Array | None = None,   # (nlay, ncol, ngpt) McICA mask
    metric_scaling: jax.Array | None = None,
    aero_species: tuple | None = None,   # STATIC active MERRA species indices
                                         # (skip zero-mass species at trace time)
    cld_mask_seed: jax.Array | None = None,  # () int32: sample the McICA mask
                                         # from this counter-based seed (ref
                                         # reset_rng_seed semantics) instead
                                         # of passing cld_mask
    col_offset: jax.Array | int = 0,     # () int32 GLOBAL index of column 0 of
                                         # this batch: makes seed-driven McICA
                                         # a pure function of (seed, global
                                         # column), bitwise-invariant to
                                         # column sharding/chunking
    eta_node_mode: str = "continuous",   # STATIC eta grid-node semantics
                                         # (gas_optics.ETA_NODE_MODES);
                                         # "reference" for golden parity runs
) -> tuple[FluxLW, SolveDiagnostics]:
    """Longwave flux solve over all g-points.

    Mirrors rte_lw_noscat_solve!/rte_lw_2stream_solve!
    (/root/reference/src/rte/longwave1scalar.jl:29-102,
     /root/reference/src/rte/longwave2stream.jl:26-101).
    """
    dtype = as_.p_lay.dtype
    Ds, wts = angular_discretization(n_gauss_angles)
    cld_mask = _mcica_mask(lkp, lkp_cld, as_, cld_mask, cld_mask_seed, col_offset)

    optics = gas_optics_lw(lkp, as_, eta_node_mode=eta_node_mode)
    tau = optics.tau
    ssa = jnp.zeros_like(tau) if two_stream else None
    g_asym = jnp.zeros_like(tau) if two_stream else None

    if lkp_cld is not None:
        tau, ssa, g_asym = _add_cloud_all(
            lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, delta_scaling=False
        )
    if lkp_aero is not None:
        tau, ssa, g_asym, _, _ = _add_aerosol_all(
            lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling=False,
            collect_aod=False, active_species=aero_species,
        )

    inc = bcs.inc_flux
    src = optics.sources
    sfc_emis = _bands_to_gpt(lkp, bcs.sfc_emis.T)  # (ncol, ngpt)
    if two_stream:
        up, dn = rte.lw_2stream(
            tau, ssa, g_asym, src.lev_source, src.sfc_source, sfc_emis, inc,
        )
        flux_up = jnp.sum(up, axis=-1)
        flux_dn = jnp.sum(dn, axis=-1)
    else:
        # Sum the single-angle no-scat transport over the quadrature angles.
        # Gauss-Jacobi-5 weights sum to 1 (angular.py), so the optional TOA
        # incident flux splits by weight: every angle then sees the same
        # isotropic intensity inc/pi. The reference carries the quadrature in
        # its solver container but runs angle 1 only
        # (/root/reference/src/optics/AngularDiscretizations.jl:32-54,
        #  src/rte/longwave1scalar.jl:14-15); multi-angle summation is this
        # framework's completion of that contract.
        flux_up = flux_dn = 0.0
        for k in range(n_gauss_angles):
            inc_k = None if inc is None else inc * dtype.type(wts[k])
            up, dn = rte.lw_noscat(
                tau, src.lay_source, src.lev_source, src.sfc_source, sfc_emis,
                float(Ds[k]), float(wts[k]), inc_k,
            )
            flux_up = flux_up + jnp.sum(up, axis=-1)
            flux_dn = flux_dn + jnp.sum(dn, axis=-1)

    flux = FluxLW(flux_up, flux_dn, flux_up - flux_dn)
    flux = _apply_metric_scaling(flux, metric_scaling)
    return flux, _cloud_diag(SolveDiagnostics(), cld_mask, dtype)


def solve_sw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: SwBCs,
    *,
    two_stream: bool = True,
    lkp_cld: CloudLookup | None = None,
    lkp_aero: AerosolLookup | None = None,
    cld_mask: jax.Array | None = None,
    metric_scaling: jax.Array | None = None,
    aero_species: tuple | None = None,   # STATIC active MERRA species indices
    cld_mask_seed: jax.Array | None = None,  # () int32 McICA seed (see solve_lw)
    col_offset: jax.Array | int = 0,     # () int32 global column-0 index (see solve_lw)
    eta_node_mode: str = "continuous",   # STATIC eta node semantics (see solve_lw)
) -> tuple[FluxSW, SolveDiagnostics]:
    """Shortwave flux solve over all g-points.

    Mirrors rte_sw_noscat_solve!/rte_sw_2stream_solve!
    (/root/reference/src/rte/shortwave1scalar.jl:27-77,
     /root/reference/src/rte/shortwave2stream.jl:36-124). Night columns
    (cos_zenith <= 0) produce exactly zero fluxes.
    """
    dtype = as_.p_lay.dtype
    ncol = as_.ncol
    mu0 = bcs.cos_zenith
    cld_mask = _mcica_mask(lkp, lkp_cld, as_, cld_mask, cld_mask_seed, col_offset)

    optics = gas_optics_sw(lkp, as_, eta_node_mode=eta_node_mode)
    tau = optics.tau
    ssa = optics.ssa if two_stream else None
    # clear-sky gas optics has zero asymmetry (Rayleigh g=0)
    g_asym = jnp.zeros_like(tau) if two_stream else None

    aod_ext = aod_sca = None
    if lkp_cld is not None:
        tau, ssa, g_asym = _add_cloud_all(
            lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, delta_scaling=True
        )
    if lkp_aero is not None:
        tau, ssa, g_asym, aod_ext, aod_sca = _add_aerosol_all(
            lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling=True,
            collect_aod=True, active_species=aero_species,
        )

    toa_gpt = bcs.toa_flux[:, None] * lkp.solar_src_scaled[None, :]  # (ncol, ngpt)
    mu0_b = jnp.broadcast_to(mu0[:, None], (ncol, lkp.n_gpt))

    if two_stream:
        alb_dir = _bands_to_gpt(lkp, bcs.sfc_alb_direct.T)    # (ncol, ngpt)
        alb_dif = _bands_to_gpt(lkp, bcs.sfc_alb_diffuse.T)
        up, dn, dn_dir = rte.sw_2stream(
            tau, ssa, g_asym, mu0_b, toa_gpt, alb_dir, alb_dif, bcs.inc_flux_diffuse
        )
        flux_up = jnp.sum(up, axis=-1)
        flux_dn = jnp.sum(dn, axis=-1)
        flux_dn_dir = jnp.sum(dn_dir, axis=-1)
    else:
        # direct-beam only: flux_up/flux_dn stay zero, like the reference's
        # OneScalar SW path (/root/reference/src/rte/shortwave1scalar.jl:92-113)
        dn_dir = rte.sw_noscat(tau, mu0_b, toa_gpt)
        flux_dn_dir = jnp.sum(dn_dir, axis=-1)
        flux_up = jnp.zeros_like(flux_dn_dir)
        flux_dn = jnp.zeros_like(flux_dn_dir)

    day = (mu0 > 0)[None, :]
    flux_up = jnp.where(day, flux_up, 0.0)
    flux_dn = jnp.where(day, flux_dn, 0.0)
    flux_dn_dir = jnp.where(day, flux_dn_dir, 0.0)
    flux = FluxSW(flux_up, flux_dn, flux_dn_dir, flux_up - flux_dn)
    flux = _apply_metric_scaling(flux, metric_scaling)
    diag = SolveDiagnostics(aod_sw_ext=aod_ext, aod_sw_sca=aod_sca)
    return flux, _cloud_diag(diag, cld_mask, dtype)
