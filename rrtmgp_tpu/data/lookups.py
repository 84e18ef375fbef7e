"""Lookup-table containers for RRTMGP k-distribution optics.

Mirrors the reference's LUT structs (/root/reference/src/optics/LookUpTables.jl)
redesigned for XLA:

- Dense coefficient tensors are pytree array leaves, with g-point LEADING
  (``kmajor (ngpt, npress+1, ntemp, neta)``) so per-g-point slabs are
  contiguous for gathers.
- Everything the reference treats as *index data* (key species per band, band
  g-point limits, minor-gas interval metadata, scaling flags) is STATIC
  python metadata (hashable tuples). Under ``jit`` the band/minor loops
  unroll at trace time into dense vectorized ops — the replacement
  for the reference's ragged per-(band, g-point) loops
  (/root/reference/src/optics/gas_optics.jl:277-303).

The reference reorders kminor into per-g-point contiguous layout
(/root/reference/ext/lookup_constructors.jl:229-308); here kminor stays in
file interval order because vectorization is per *interval* (each interval
covers a contiguous g-point range with one contributor column per g-point).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax

from ..utils.pytree import pytree_dataclass


class MinorInterval(NamedTuple):
    """Static metadata for one minor-gas absorption interval.

    One row of the reference's packed 4 x n gasdata matrix plus its g-point
    limits (/root/reference/ext/lookup_constructors.jl:282-308). All indices
    0-based; ``gas``/``scaling_gas`` index the vmr table (-1 = none);
    g-point range is [gpt0, gpt1) ; ``k0`` is the row offset of this
    interval's first contributor in the kminor array.
    """

    gas: int
    scaling_gas: int
    scales_with_density: bool
    scale_by_complement: bool
    gpt0: int
    gpt1: int
    k0: int


@pytree_dataclass(
    meta_fields=(
        "idx_h2o",
        "p_ref_tropo",
        "p_ref_min",
        "key_species",
        "bnd_lims_gpt",
        "minor_lower",
        "minor_upper",
        "gas_names",
        "n_eta",
        "n_press",
        "n_temp",
        "t_ref_min",
        "t_ref_delta",
        "ln_p_ref_max",
        "ln_p_ref_delta",
        "t_planck_min",
        "t_planck_delta",
        "solar_src_tot",
    )
)
class GasLookup:
    """Gas-optics lookup tables for one band-set (LW or SW).

    Array fields (jax leaves):
      kmajor          (ngpt, npress+1, ntemp, neta)   major absorption coeff
      kminor_lower    (ncontrib_lower, ntemp, neta)   minor coeffs, lower atmos
      kminor_upper    (ncontrib_upper, ntemp, neta)
      eta_half        (nbnd, 2, ntemp)  vmr_ref ratio of key species (tropo axis: 0=lower, 1=upper)
      planck_fraction (ngpt, npress+1, ntemp, neta)   LW only, else None
      totplnk         (n_t_plnk, nbnd)                LW only
      rayl            (2, ngpt, ntemp, neta)          SW only (0=lower, 1=upper)
      solar_src_scaled(ngpt,)                         SW only

    Static metadata:
      key_species  ((lower_pair, upper_pair) per band), 0-based vmr indices,
                   reference's 0/0 -> 2/2 rule already applied
                   (/root/reference/ext/lookup_constructors.jl:147-153)
      bnd_lims_gpt ((gpt0, gpt1) exclusive-end, 0-based, per band)
      minor_lower/minor_upper  tuple[MinorInterval, ...]
      t_ref_min/t_ref_delta etc: uniform grids for index math
    """

    kmajor: jax.Array
    kminor_lower: jax.Array
    kminor_upper: jax.Array
    eta_half: jax.Array
    planck_fraction: jax.Array | None
    totplnk: jax.Array | None
    rayl: jax.Array | None
    solar_src_scaled: jax.Array | None

    idx_h2o: int
    p_ref_tropo: float
    p_ref_min: float
    key_species: tuple
    bnd_lims_gpt: tuple
    minor_lower: tuple
    minor_upper: tuple
    gas_names: tuple
    n_eta: int
    n_press: int
    n_temp: int
    t_ref_min: float
    t_ref_delta: float
    ln_p_ref_max: float
    ln_p_ref_delta: float
    t_planck_min: float
    t_planck_delta: float
    solar_src_tot: float

    @property
    def n_gpt(self) -> int:
        return self.kmajor.shape[0]

    @property
    def n_bnd(self) -> int:
        return len(self.bnd_lims_gpt)

    @property
    def is_longwave(self) -> bool:
        return self.planck_fraction is not None

    def gpt2band(self, igpt: int) -> int:
        for ibnd, (g0, g1) in enumerate(self.bnd_lims_gpt):
            if g0 <= igpt < g1:
                return ibnd
        raise ValueError(f"g-point {igpt} out of range")


@pytree_dataclass(meta_fields=("nsize_liq", "nsize_ice", "nrghice"))
class CloudLookup:
    """Cloud optics LUT (ref /root/reference/src/optics/LookUpTables.jl:204-254).

    liq (3, nsize_liq, nbnd): ext/ssa/asy vs liquid effective radius
    ice (3, nsize_ice, nbnd, nrghice): same for ice x roughness
    bounds: (radliq_lwr, radliq_upr, radice_lwr, radice_upr) as python floats
    """

    liq: jax.Array
    ice: jax.Array
    bnd_lims_wn: jax.Array
    radliq_lwr: jax.Array
    radliq_upr: jax.Array
    radice_lwr: jax.Array
    radice_upr: jax.Array
    nsize_liq: int
    nsize_ice: int
    nrghice: int


@pytree_dataclass(meta_fields=("iband_550nm", "n_bin", "n_rh"))
class AerosolLookup:
    """MERRA aerosol LUT (ref /root/reference/src/optics/LookUpTables.jl:271-297).

    All property tables carry (ext, ssa, asy) on the leading axis (nval=3).
      dust             (3, nbin, nband)
      sea_salt         (3, nrh, nbin, nband)
      sulfate          (3, nrh, nband)
      black_carbon_rh  (3, nrh, nband)
      black_carbon     (3, nband)
      organic_carbon_rh(3, nrh, nband)
      organic_carbon   (3, nband)
    """

    size_bin_limits: jax.Array  # (2, nbin)
    rh_levels: jax.Array        # (nrh,)
    dust: jax.Array
    sea_salt: jax.Array
    sulfate: jax.Array
    black_carbon_rh: jax.Array
    black_carbon: jax.Array
    organic_carbon_rh: jax.Array
    organic_carbon: jax.Array
    bnd_lims_wn: jax.Array
    iband_550nm: int  # 0-based; -1 if absent
    n_bin: int
    n_rh: int


def band_limits_to_gpt2band(bnd_lims_gpt: tuple, n_gpt: int):
    """Dense 0-based g-point -> band map from static band limits."""
    import numpy as np

    g2b = np.zeros((n_gpt,), dtype=np.int32)
    for ibnd, (g0, g1) in enumerate(bnd_lims_gpt):
        g2b[g0:g1] = ibnd
    return g2b
