"""MERRA aerosol optics.

Mirrors /root/reference/src/optics/aerosol_optics.jl vectorized over
(nlay, ncol) per band: the 7 aerosol species families (dust x 5 size bins,
sea salt x 5 RH-dependent bins, sulfate, black/organic carbon in hydrophobic
and RH-dependent hydrophilic forms) accumulate (tau, tau*ssa, tau*ssa*g),
which then increments the gas optics via increment_2stream, with optional SW
delta scaling and AOD-at-550nm diagnostics.

MERRA type indexing (0-based here; reference 1-based list at
/root/reference/src/api/api_methods.jl:49-65):
  0: dust1, 1: sea_salt1, 2: sulfate, 3: black_carbon_rh, 4: black_carbon,
  5: organic_carbon_rh, 6: organic_carbon, 7-10: dust2-5, 11-14: sea_salt2-5
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..data.lookups import AerosolLookup
from ..states import AerosolState
from .cloud_optics import delta_scale, increment_2stream

DUST_IDXS = (0, 7, 8, 9, 10)
SALT_IDXS = (1, 11, 12, 13, 14)
SULFATE_IDX = 2
BC_RH_IDX = 3
BC_IDX = 4
OC_RH_IDX = 5
OC_IDX = 6


def _locate_size_bin(size_bin_limits: jax.Array, aerosize: jax.Array) -> jax.Array:
    """MERRA size-bin search (ref aerosol_optics.jl:313-326): first bin whose
    [lo, hi] contains the size; default = last bin."""
    lo = size_bin_limits[0]  # (nbin,)
    hi = size_bin_limits[1]
    nbin = lo.shape[0]
    inside = (aerosize[..., None] >= lo) & (aerosize[..., None] <= hi)  # (..., nbin)
    first = jnp.argmax(inside, axis=-1)
    any_in = jnp.any(inside, axis=-1)
    return jnp.where(any_in, first, nbin - 1).astype(jnp.int32)


def _rh_loc_factor(rh_levels: jax.Array, rh: jax.Array):
    """Non-uniform 1D interp location/factor with endpoint clamping
    (ref optics_utils.jl:49-57)."""
    n = rh_levels.shape[0]
    # searchsorted: index of first level > rh
    idx = jnp.searchsorted(rh_levels, rh, side="right")
    loc = jnp.clip(idx - 1, 0, n - 2).astype(jnp.int32)
    denom = rh_levels[loc + 1] - rh_levels[loc]
    factor = (rh - rh_levels[loc]) / denom
    factor = jnp.clip(factor, 0.0, 1.0)
    return loc, factor


def _accum(table_vals, mass):
    """(ext, ssa, asy) values -> (tau, tau*ssa, tau*ssa*g) x mass."""
    ext, ssa, asy = table_vals
    tau = mass * ext
    tau_ssa = tau * ssa
    tau_ssag = tau_ssa * asy
    return tau, tau_ssa, tau_ssag


def aerosol_optics_band(lkp: AerosolLookup, aero: AerosolState, rel_hum: jax.Array, ibnd: int):
    """Cumulative aerosol (tau, tau*ssa, tau*ssa*g) for one band, (nlay, ncol).

    Ref compute_lookup_aerosol (/root/reference/src/optics/aerosol_optics.jl:121-185).
    """
    mass = aero.aero_mass  # (n_aero, nlay, ncol)
    size = aero.aero_size
    loc, factor = _rh_loc_factor(lkp.rh_levels, rel_hum)  # (nlay, ncol)
    omf = 1.0 - factor

    tau = jnp.zeros_like(rel_hum)
    tau_ssa = jnp.zeros_like(rel_hum)
    tau_ssag = jnp.zeros_like(rel_hum)

    def add(contrib, active):
        nonlocal tau, tau_ssa, tau_ssag
        t, ts, tsg = contrib
        tau = tau + jnp.where(active, t, 0.0)
        tau_ssa = tau_ssa + jnp.where(active, ts, 0.0)
        tau_ssag = tau_ssag + jnp.where(active, tsg, 0.0)

    # dust: size-binned, no RH
    for i in DUST_IDXS:
        m = mass[i]
        bin_ = _locate_size_bin(lkp.size_bin_limits, size[i])
        vals = tuple(lkp.dust[v, bin_, ibnd] for v in range(3))
        add(_accum(vals, m), m > 0.0)

    # sea salt: size-binned + RH interp
    for i in SALT_IDXS:
        m = mass[i]
        bin_ = _locate_size_bin(lkp.size_bin_limits, size[i])
        vals = tuple(
            lkp.sea_salt[v, loc, bin_, ibnd] * omf + lkp.sea_salt[v, loc + 1, bin_, ibnd] * factor
            for v in range(3)
        )
        add(_accum(vals, m), m > 0.0)

    # sulfate: RH interp
    m = mass[SULFATE_IDX]
    vals = tuple(lkp.sulfate[v, loc, ibnd] * omf + lkp.sulfate[v, loc + 1, ibnd] * factor for v in range(3))
    add(_accum(vals, m), m > 0.0)

    # black carbon hydrophilic (RH) and hydrophobic
    m = mass[BC_RH_IDX]
    vals = tuple(
        lkp.black_carbon_rh[v, loc, ibnd] * omf + lkp.black_carbon_rh[v, loc + 1, ibnd] * factor
        for v in range(3)
    )
    add(_accum(vals, m), m > 0.0)
    m = mass[BC_IDX]
    vals = tuple(jnp.broadcast_to(lkp.black_carbon[v, ibnd], m.shape) for v in range(3))
    add(_accum(vals, m), m > 0.0)

    # organic carbon hydrophilic (RH) and hydrophobic
    m = mass[OC_RH_IDX]
    vals = tuple(
        lkp.organic_carbon_rh[v, loc, ibnd] * omf + lkp.organic_carbon_rh[v, loc + 1, ibnd] * factor
        for v in range(3)
    )
    add(_accum(vals, m), m > 0.0)
    m = mass[OC_IDX]
    vals = tuple(jnp.broadcast_to(lkp.organic_carbon[v, ibnd], m.shape) for v in range(3))
    add(_accum(vals, m), m > 0.0)

    return tau, tau_ssa, tau_ssag


def _dot_h(w, lut2):
    return jax.lax.dot_general(
        w, lut2, (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    )


def aerosol_optics_bands(
    lkp: AerosolLookup, aero: AerosolState, rel_hum: jax.Array,
    active_species: tuple | None = None,
):
    """Cumulative aerosol (tau, tau*ssa, tau*ssa*g) for ALL bands at once,
    each (nlay, ncol, nbnd).

    active_species: optional STATIC tuple of MERRA species indices known by
    the host to carry mass; the others are skipped at trace time (their
    contribution is identically zero — the per-cell mass>0 mask already
    zeroes them — so results are unchanged). Hosts typically load 3-6 of the
    15 species; the skip removes ~2/3 of the band-prep HBM traffic.

    One-hot-matmul formulation of compute_lookup_aerosol
    (ref aerosol_optics.jl:121-185): instead of dozens of pointwise gathers
    of the tiny MERRA tables per band, the RH and size-bin lookups become
    (rows, n) interpolation-weight matrices contracted against (n, 3*nbnd)
    table views — one matmul per species family fetches every band and
    property."""
    dtype = rel_hum.dtype
    nlay, ncol = rel_hum.shape
    rows = nlay * ncol
    nbnd = lkp.dust.shape[-1]
    mass = aero.aero_mass
    size = aero.aero_size

    loc, factor = _rh_loc_factor(lkp.rh_levels, rel_hum)
    nrh = lkp.rh_levels.shape[0]
    locf = loc.reshape(-1, 1)
    facf = factor.reshape(-1, 1).astype(dtype)
    iota_rh = jnp.arange(nrh, dtype=jnp.int32)
    w_rh = jnp.where(iota_rh == locf, 1.0 - facf, 0.0) + jnp.where(
        iota_rh == locf + 1, facf, 0.0
    )  # (rows, nrh)

    nbin = lkp.size_bin_limits.shape[1]
    iota_bin = jnp.arange(nbin, dtype=jnp.int32)

    tau = jnp.zeros((nlay, ncol, nbnd), dtype)
    tau_ssa = jnp.zeros_like(tau)
    tau_ssag = jnp.zeros_like(tau)

    def lut2(t):  # (3, n, nbnd) -> (n, 3*nbnd)
        return jnp.moveaxis(t.astype(dtype), 0, 1).reshape(t.shape[1], 3 * nbnd)

    def add(vals3, m):
        # vals3: (rows, 3*nbnd) -> masked accumulate of tau / tau*ssa / tau*ssa*g
        nonlocal tau, tau_ssa, tau_ssag
        v = vals3.reshape(nlay, ncol, 3, nbnd)
        mm = m[:, :, None]
        t = jnp.where(mm > 0.0, mm * v[:, :, 0], 0.0)
        ts = t * v[:, :, 1]
        tau += t
        tau_ssa += ts
        tau_ssag += ts * v[:, :, 2]

    def on(i):
        return active_species is None or i in active_species

    dust2 = lut2(lkp.dust)
    for i in DUST_IDXS:
        if not on(i):
            continue
        bin_ = _locate_size_bin(lkp.size_bin_limits, size[i]).reshape(-1, 1)
        w_bin = (iota_bin == bin_).astype(dtype)
        add(_dot_h(w_bin, dust2), mass[i])

    ss2 = jnp.moveaxis(lkp.sea_salt.astype(dtype), 0, 2).reshape(nrh * nbin, 3 * nbnd)
    for i in SALT_IDXS:
        if not on(i):
            continue
        bin_ = _locate_size_bin(lkp.size_bin_limits, size[i]).reshape(-1, 1)
        w_bin = (iota_bin == bin_).astype(dtype)
        w_joint = (w_rh[:, :, None] * w_bin[:, None, :]).reshape(rows, nrh * nbin)
        add(_dot_h(w_joint, ss2), mass[i])

    if on(SULFATE_IDX):
        add(_dot_h(w_rh, lut2(lkp.sulfate)), mass[SULFATE_IDX])
    if on(BC_RH_IDX):
        add(_dot_h(w_rh, lut2(lkp.black_carbon_rh)), mass[BC_RH_IDX])
    if on(OC_RH_IDX):
        add(_dot_h(w_rh, lut2(lkp.organic_carbon_rh)), mass[OC_RH_IDX])

    # hydrophobic BC/OC: band vectors, no per-cell lookup
    for tbl, idx in ((lkp.black_carbon, BC_IDX), (lkp.organic_carbon, OC_IDX)):
        if not on(idx):
            continue
        v = jnp.broadcast_to(
            tbl.astype(dtype).reshape(1, 3 * nbnd), (rows, 3 * nbnd)
        )
        add(v, mass[idx])

    return tau, tau_ssa, tau_ssag
