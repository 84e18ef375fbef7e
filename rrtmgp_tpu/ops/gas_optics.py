"""RRTMGP k-distribution gas optics, batched XLA formulation.

Mirrors the numerics of the reference's per-(layer, g-point) scalar kernel
(/root/reference/src/optics/gas_optics.jl:166-335 and
 /root/reference/src/optics/optics_utils.jl) with a different decomposition:

- Pressure/temperature interpolation indices are computed once per
  (layer, column) — they are g-point independent.
- The 8-point trilinear LUT interpolation (optics_utils.jl:123-149) is
  reorganized as a ROW GATHER: for one (layer, column), all g-points and eta
  nodes read the same 4 (press, temp) slabs of the table. Whole contiguous
  (ngpt*neta) rows are gathered instead of pointwise elements, and the eta
  interpolation then contracts the trailing eta axis with per-band one-hot
  weights.
- Eta (binary species parameter) data is computed at BAND granularity —
  a short trace-time loop over the static key-species table.
- The minor-gas interval loop (dozens of intervals) unrolls at trace time
  over static metadata with the same row-gather pattern over the temperature
  axis — replacing the reference's ragged per-g-point loops
  (gas_optics.jl:277-303).

LAYOUT: optics tensors are (nlay, ncol, ngpt) — vertical axis leading for the
RTE scans, g-points on the minor (contiguous) axis; the g-point flux
reduction is a minor-axis sum.

Index conventions: level/layer 0 = surface; g-points and bands 0-based;
gas indices 1-based matching the reference's vmr convention.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..data.lookups import GasLookup
from ..states import AtmosphericState, get_vmr


class PTInterp(NamedTuple):
    """Per-(layer, column) pressure/temperature interpolation data."""

    jtemp: jax.Array       # (nlay, ncol) int, 0-based lower temp index
    ftemp: jax.Array       # (nlay, ncol)
    jpress_base: jax.Array # (nlay, ncol) int, base slab on the (npress+1) axis
    fpress: jax.Array      # (nlay, ncol)
    tropo_lower: jax.Array # (nlay, ncol) bool, True = lower atmosphere


class EtaInterp(NamedTuple):
    """Eta interpolation data at band granularity, each (nlay, ncol, nbnd)."""

    jeta1: jax.Array
    feta1: jax.Array
    jeta2: jax.Array
    feta2: jax.Array
    col_mix1: jax.Array
    col_mix2: jax.Array


def compute_pt_interp(lkp: GasLookup, p_lay: jax.Array, t_lay: jax.Array) -> PTInterp:
    """Temperature/pressure interp fractions (ref gas_optics.jl:82-108).

    The temp/ln-p reference grids are uniform; indices come from grid math
    (the reference's loc_lower), clamped like the reference.
    """
    # temperature: jtemp in [0, n_temp-2]
    loc_t = (t_lay - lkp.t_ref_min) / lkp.t_ref_delta
    jtemp = jnp.clip(jnp.floor(loc_t), 0, lkp.n_temp - 2).astype(jnp.int32)
    ftemp = loc_t - jtemp

    # pressure: jp in [0, n_press-2] on the ln p grid (decreasing pressure)
    log_p = jnp.log(p_lay)
    loc_p = (lkp.ln_p_ref_max - log_p) / lkp.ln_p_ref_delta
    jp = jnp.clip(jnp.floor(loc_p), 0, lkp.n_press - 2).astype(jnp.int32)
    fpress = loc_p - jp

    tropo_lower = p_lay > lkp.p_ref_tropo
    # kmajor press axis has n_press+1 slabs; lower uses (jp, jp+1),
    # upper uses (jp+1, jp+2)  (ref gas_optics.jl:101-108 + interp3d indexing)
    jpress_base = jp + jnp.where(tropo_lower, 0, 1)
    return PTInterp(jtemp, ftemp, jpress_base, fpress, tropo_lower)


#: eta grid-node semantics at EXACT nodes (eta*(n_eta-1) integral, which
#: happens on real data wherever the second key species' VMR is exactly 0):
#: - "continuous": fraction against the CLAMPED index — at eta == 1 the value
#:   comes entirely from node n_eta-1; the interpolation is continuous in eta.
#: - "reference": fraction = frac(loc_eta) like the reference (and the
#:   Fortran that produced the golden files): at an exact node the value
#:   comes entirely from the LOWER node — a full-cell jump at eta == 1
#:   (ref /root/reference/src/optics/gas_optics.jl:134-136).
#: The two modes are bitwise identical everywhere off-node. Golden runs
#: against real Fortran reference data must use "reference" (see PARITY.md).
ETA_NODE_MODES = ("continuous", "reference")


def _eta_frac(loc_eta, jeta_f, node_mode: str):
    """Eta interpolation fraction per ETA_NODE_MODES. jeta_f = clamped index."""
    if node_mode not in ETA_NODE_MODES:
        raise ValueError(f"eta node_mode {node_mode!r} not in {ETA_NODE_MODES}")
    if node_mode == "continuous":
        return loc_eta - jeta_f
    return loc_eta - jnp.floor(loc_eta)


def compute_eta_interp(
    lkp: GasLookup, vmr, pt: PTInterp, node_mode: str = "continuous"
) -> EtaInterp:
    """Tropo-selected eta data stacked over bands: each field (nlay, ncol, nbnd).

    Vectorized over the band axis: key-species VMRs are stacked at trace time
    (static key_species table), then one fused chain computes all bands'
    col_mix/eta/indices at once (a per-band loop here cost ~25% of the whole
    LW optics in small VPU ops). node_mode: see ETA_NODE_MODES.
    """
    nbnd = lkp.n_bnd
    n_eta = lkp.n_eta
    dtype = lkp.eta_half.dtype
    shape2d = pt.jtemp.shape

    def vmr_stack(slot):
        cols = []
        for b in range(nbnd):
            pair = [
                jnp.broadcast_to(get_vmr(vmr, lkp.key_species[b][t][slot]), shape2d)
                for t in (0, 1)
            ]
            cols.append(jnp.stack(pair, axis=-1))
        return jnp.stack(cols, axis=-2).astype(dtype)  # (nlay, ncol, nbnd, 2)

    sel = pt.tropo_lower[..., None]
    vmr1s = vmr_stack(0)
    vmr2s = vmr_stack(1)
    vmr1 = jnp.where(sel, vmr1s[..., 0], vmr1s[..., 1])  # (nlay, ncol, nbnd)
    vmr2 = jnp.where(sel, vmr2s[..., 0], vmr2s[..., 1])

    # eta_half rows by temperature: (nbnd, 2, ntemp) -> (ntemp, nbnd, 2).
    # The row lookup at jtemp/jtemp+1 runs as a one-hot matmul over the tiny
    # temperature axis instead of narrow (nbnd*2-wide) row gathers at every
    # (layer, column). HIGHEST keeps the 0/1 weights exact in f32.
    eh = jnp.transpose(lkp.eta_half, (2, 0, 1))
    ntemp = eh.shape[0]
    eh2 = eh.reshape(ntemp, -1)                           # (ntemp, nbnd*2)
    # row j of eh_cat = [eh[j] | eh[j+1]] (jtemp <= ntemp-2, so the wrap row
    # of roll is never selected)
    eh_cat = jnp.concatenate([eh2, jnp.roll(eh2, -1, axis=0)], axis=1)
    iota_t = jnp.arange(ntemp, dtype=jnp.int32)
    if dtype == jnp.float64:
        # exact f32-split extraction (see _f64_dot_extract)
        w_t32 = (pt.jtemp[..., None] == iota_t).astype(jnp.float32)
        ehg_both = _f64_dot_extract(w_t32, jnp.asarray(eh_cat, jnp.float64))
    else:
        w_t = (pt.jtemp[..., None] == iota_t).astype(eh2.dtype)
        ehg_both = jax.lax.dot_general(
            w_t, eh_cat, (((w_t.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # (nlay, ncol, 2 * nbnd * 2)
    nb2 = eh2.shape[1]

    outs = []
    for itemp in (0, 1):
        ehg = ehg_both[..., itemp * nb2 : (itemp + 1) * nb2].reshape(
            *pt.jtemp.shape, nbnd, 2
        )
        eta_half = jnp.where(sel, ehg[..., 0], ehg[..., 1])
        col_mix = vmr1 + eta_half * vmr2
        eta = jnp.where(col_mix > 0.0, vmr1 / jnp.where(col_mix > 0.0, col_mix, 1.0), 0.5)
        loc_eta = eta * (n_eta - 1)
        jeta_f = jnp.minimum(jnp.floor(loc_eta), n_eta - 2)
        jeta = jeta_f.astype(jnp.int32)
        # node semantics at exact eta grid nodes are switchable (default
        # "continuous" — reads node n_eta-1 with weight 1 at eta == 1;
        # "reference" reproduces the full-cell jump of gas_optics.jl:134-136
        # for golden parity runs). See ETA_NODE_MODES.
        feta = _eta_frac(loc_eta, jeta_f, node_mode)
        outs.append((jeta, feta, col_mix))
    (j1, f1, c1), (j2, f2, c2) = outs
    return EtaInterp(j1, f1, j2, f2, c1, c2)


def gpt2band_np(lkp: GasLookup) -> np.ndarray:
    g2b = np.zeros((lkp.n_gpt,), np.int32)
    for ibnd, (g0, g1) in enumerate(lkp.bnd_lims_gpt):
        g2b[g0:g1] = ibnd
    return g2b


def _f64_dot_extract(w_f32, table64, cols_exact=True):
    """dot(one-hot w, f64 table) computed EXACTLY with two f32 dots.

    A one-hot f32 dot at HIGHEST precision picks rows exactly, and an f64
    value splits exactly into two f32 words, so hi/lo extraction + f64
    recombine is BITWISE the gathered value. (Written for a backend without
    native f64 dots; whether it still pays where f64 is native is open.)"""
    hi = table64.astype(jnp.float32)
    lo = (table64 - hi.astype(jnp.float64)).astype(jnp.float32)
    cat = jnp.concatenate([hi, lo], axis=1)
    r = jax.lax.dot_general(
        w_f32, cat, (((w_f32.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    n = table64.shape[1]
    return r[..., :n].astype(jnp.float64) + r[..., n:].astype(jnp.float64)


def _eta_onehot(je: jax.Array, fe: jax.Array, n_eta: int, dtype):
    """One-hot eta weights (..., n_eta) from index/fraction (...)."""
    e = jnp.arange(n_eta, dtype=jnp.int32)
    je_x = je[..., None]
    fe_x = fe[..., None].astype(dtype)
    return jnp.where(e == je_x, 1.0 - fe_x, 0.0) + jnp.where(e == je_x + 1, fe_x, 0.0)


def _contract_eta_by_band(R, eta_w, bnd_lims_gpt):
    """Contract trailing eta axis with per-band weights.

    R: (nlay, ncol, ngpt, neta); eta_w: (nlay, ncol, nbnd, neta) one-hot
    weights; returns (nlay, ncol, ngpt). Static band loop, dense inside.
    """
    pieces = []
    for ibnd, (g0, g1) in enumerate(bnd_lims_gpt):
        w = eta_w[:, :, ibnd, None, :]          # (nlay, ncol, 1, neta)
        pieces.append(jnp.sum(R[:, :, g0:g1, :] * w, axis=-1))
    return jnp.concatenate(pieces, axis=-1)


def _interp3d_rowgather(table, pt: PTInterp, eta: EtaInterp, lkp: GasLookup, use_colmix: bool):
    """Trilinear table interpolation via 4 contiguous row gathers + eta
    contraction. table: (ngpt, npress+1, ntemp, neta);
    returns (nlay, ncol, ngpt). Matches interp3d (ref optics_utils.jl:123-149)
    with col_mix scaling the two temperature halves when ``use_colmix``.
    """
    ngpt, npp, ntemp, neta = table.shape
    dtype = table.dtype
    # rows indexed by combined (press_slab, temp); row content (ngpt * neta)
    K3 = table.transpose(1, 2, 0, 3).reshape(npp * ntemp, ngpt * neta)
    fp = pt.fpress[..., None].astype(dtype)

    out = 0.0
    for half in (0, 1):
        q0 = pt.jpress_base * ntemp + pt.jtemp + half      # (nlay, ncol)
        r0 = K3[q0]                                         # (nlay, ncol, ngpt*neta)
        r1 = K3[q0 + ntemp]
        Rh = ((1.0 - fp) * r0 + fp * r1).reshape(*q0.shape, ngpt, neta)
        je = eta.jeta1 if half == 0 else eta.jeta2          # (nlay, ncol, nbnd)
        fe = eta.feta1 if half == 0 else eta.feta2
        eta_w = _eta_onehot(je, fe, neta, dtype)            # (nlay, ncol, nbnd, neta)
        if use_colmix:
            s = eta.col_mix1 if half == 0 else eta.col_mix2  # (nlay, ncol, nbnd)
            eta_w = eta_w * s[..., None]
        val = _contract_eta_by_band(Rh, eta_w, lkp.bnd_lims_gpt)  # (nlay, ncol, ngpt)
        w_t = (pt.ftemp if half else (1.0 - pt.ftemp))[..., None].astype(dtype)
        out = out + w_t * val
    return out


def compute_tau_major(lkp: GasLookup, col_dry, pt: PTInterp, eta: EtaInterp) -> jax.Array:
    """Major-species optical depth (nlay, ncol, ngpt) (ref gas_optics.jl:188)."""
    tau = _interp3d_rowgather(lkp.kmajor, pt, eta, lkp, use_colmix=True)
    return tau * col_dry[..., None]


def compute_planck_fraction(lkp: GasLookup, pt: PTInterp, eta: EtaInterp) -> jax.Array:
    """Planck fraction (nlay, ncol, ngpt) (ref gas_optics.jl:184-185)."""
    return _interp3d_rowgather(lkp.planck_fraction, pt, eta, lkp, use_colmix=False)


def compute_tau_minor(
    lkp: GasLookup, vmr, col_dry, p_lay, t_lay, pt: PTInterp, eta: EtaInterp
) -> jax.Array:
    """Minor-gas optical depth (nlay, ncol, ngpt) (ref gas_optics.jl:255-306).

    Static unroll over minor intervals; per interval, a 2-row gather over the
    temperature axis + eta contraction, masked by troposphere side. The
    scaling-law branches resolve at trace time from static flags.
    """
    nlay, ncol = p_lay.shape
    dtype = col_dry.dtype
    neta = lkp.n_eta
    ntemp = lkp.n_temp
    tau = jnp.zeros((nlay, ncol, lkp.n_gpt), dtype)

    vmr_h2o = get_vmr(vmr, lkp.idx_h2o)
    dry_fact = 1.0 / (1.0 + vmr_h2o)             # (nlay, ncol) or scalar
    density_fact = 0.01 * p_lay / t_lay          # pa2hpa * p / t

    g2b = gpt2band_np(lkp)
    for tropo, intervals, kminor in (
        (0, lkp.minor_lower, lkp.kminor_lower),
        (1, lkp.minor_upper, lkp.kminor_upper),
    ):
        mask = pt.tropo_lower if tropo == 0 else jnp.logical_not(pt.tropo_lower)
        for itv in intervals:
            if itv.gas == 0:
                continue
            vmr_m = get_vmr(vmr, itv.gas)
            scaling = vmr_m * col_dry
            if itv.scales_with_density:
                scaling = scaling * density_fact
                if itv.scaling_gas > 0:
                    sg = get_vmr(vmr, itv.scaling_gas)
                    if itv.scale_by_complement:
                        scaling = scaling * (1.0 - sg * dry_fact)
                    else:
                        scaling = scaling * (sg * dry_fact)
            ng = itv.gpt1 - itv.gpt0
            ibnd = int(g2b[itv.gpt0])
            # 4-point (temp x eta) gathers: same interp2d arithmetic as the
            # one-hot form (ref gas_optics.jl:255-306) but only the 4 active
            # nodes are gathered — no (nlay, ncol, ng, neta) one-hot
            # temporaries
            krows = kminor[itv.k0 : itv.k0 + ng]            # (ng, ntemp, neta)
            K2 = jnp.asarray(krows, dtype).transpose(1, 2, 0).reshape(
                ntemp * neta, ng
            )
            fe1 = eta.feta1[:, :, ibnd][..., None].astype(dtype)
            fe2 = eta.feta2[:, :, ibnd][..., None].astype(dtype)
            i00 = pt.jtemp * neta + eta.jeta1[:, :, ibnd]
            i10 = (pt.jtemp + 1) * neta + eta.jeta2[:, :, ibnd]
            v1 = (1.0 - fe1) * K2[i00] + fe1 * K2[i00 + 1]
            v2 = (1.0 - fe2) * K2[i10] + fe2 * K2[i10 + 1]
            ft = pt.ftemp[..., None].astype(dtype)
            contrib = (1.0 - ft) * v1 + ft * v2                 # (nlay, ncol, ng)
            contrib = contrib * (scaling * jnp.where(mask, 1.0, 0.0))[..., None]
            tau = tau.at[:, :, itv.gpt0 : itv.gpt1].add(contrib)
    return tau


def compute_tau_rayleigh(lkp: GasLookup, vmr, col_dry, pt: PTInterp, eta: EtaInterp) -> jax.Array:
    """Rayleigh scattering optical depth (nlay, ncol, ngpt)
    (ref gas_optics.jl:324-335). Row gather over combined (tropo, temp)."""
    ngpt = lkp.n_gpt
    ntemp = lkp.n_temp
    neta = lkp.n_eta
    dtype = lkp.rayl.dtype
    vmr_h2o = get_vmr(vmr, lkp.idx_h2o)
    factor = ((vmr_h2o + 1.0) * col_dry)[..., None]  # (nlay, ncol, 1)

    # rows indexed by combined (tropo, temp); content (ngpt * neta)
    K3 = lkp.rayl.transpose(0, 2, 1, 3).reshape(2 * ntemp, ngpt * neta)
    tropo_off = jnp.where(pt.tropo_lower, 0, ntemp)
    ft = pt.ftemp[..., None].astype(dtype)

    out = 0.0
    for half in (0, 1):
        q = tropo_off + pt.jtemp + half
        Rh = K3[q].reshape(*q.shape, ngpt, neta)
        je = eta.jeta1 if half == 0 else eta.jeta2
        fe = eta.feta1 if half == 0 else eta.feta2
        eta_w = _eta_onehot(je, fe, neta, dtype)
        val = _contract_eta_by_band(Rh, eta_w, lkp.bnd_lims_gpt)
        w_t = ft if half else (1.0 - ft)
        out = out + w_t * val
    return out * factor


def _planck_interp_band(lkp: GasLookup, t, ibnd: int):
    """interp1d_equispaced of totplnk[:, ibnd] at temperatures ``t`` with
    endpoint clamping (ref optics_utils.jl:32-42)."""
    tp = lkp.totplnk[:, ibnd]  # (n_t_plnk,)
    n = tp.shape[0]
    loc = (t - lkp.t_planck_min) / lkp.t_planck_delta
    j = jnp.clip(jnp.floor(loc), 0, n - 2).astype(jnp.int32)
    f = loc - j
    lin = tp[j] * (1.0 - f) + tp[j + 1] * f
    t_max = lkp.t_planck_min + (n - 1) * lkp.t_planck_delta
    return jnp.where(t < lkp.t_planck_min, tp[0], jnp.where(t > t_max, tp[-1], lin))


def _band_expand_matrix(lkp: GasLookup):
    m = np.zeros((lkp.n_bnd, lkp.n_gpt), np.float32)
    for i, (g0, g1) in enumerate(lkp.bnd_lims_gpt):
        m[i, g0:g1] = 1.0
    return jnp.asarray(m)


def _planck_bands_to_gpt(lkp: GasLookup, t):
    """Planck source interp, expanded to g-points.

    t: (..., ncol) temperatures; returns (..., ncol, ngpt) with the band
    value broadcast over that band's g-points. The equispaced 1-D
    interpolation is a 2-hot matmul against the whole (n_t_plnk, nbnd)
    table — one contraction for ALL bands, instead of pointwise tp[j]
    gathers — and the band->gpt expansion is a second matmul against the
    0/1 band matrix.
    Endpoint clamping matches interp1d_equispaced (ref optics_utils.jl:32-42).
    """
    tp = lkp.totplnk  # (n_t_plnk, nbnd)
    n = tp.shape[0]
    dtype = t.dtype
    loc = (t - lkp.t_planck_min) / lkp.t_planck_delta
    j = jnp.clip(jnp.floor(loc), 0, n - 2)
    f = jnp.clip(loc - j, 0.0, 1.0)  # clamp => y[0] / y[-1] outside the grid
    hp = jax.lax.Precision.HIGHEST
    if dtype == jnp.float64:
        # extract rows T[j], T[j+1] exactly with f32-split one-hot dots
        # ([tp | roll(tp)] supplies j+1 from the same one-hot) and apply
        # the f64 weights elementwise — the SAME two products + one add
        # the 2-hot dot performed
        tp64 = jnp.asarray(tp, jnp.float64)
        tp_cat = jnp.concatenate([tp64, jnp.roll(tp64, -1, axis=0)], axis=1)
        w32 = (j.astype(jnp.int32)[..., None] == jnp.arange(n, dtype=jnp.int32)
               ).astype(jnp.float32)
        both = _f64_dot_extract(w32, tp_cat)  # (..., 2*nbnd)
        nbnd = tp.shape[1]
        fx = f[..., None]
        per_band = (1.0 - fx) * both[..., :nbnd] + fx * both[..., nbnd:]
        # band->gpt expansion as static lane broadcasts (exact, dot-free)
        return jnp.concatenate(
            [
                jnp.broadcast_to(
                    per_band[..., i : i + 1], (*per_band.shape[:-1], g1 - g0)
                )
                for i, (g0, g1) in enumerate(lkp.bnd_lims_gpt)
            ],
            axis=-1,
        )
    iota = jnp.arange(n, dtype=dtype)
    w = jnp.where(iota == j[..., None], 1.0 - f[..., None], 0.0) + jnp.where(
        iota == j[..., None] + 1.0, f[..., None], 0.0
    )  # (..., ncol, n_t_plnk)
    per_band = jax.lax.dot_general(
        w, tp.astype(dtype), (((w.ndim - 1,), (0,)), ((), ())), precision=hp
    )  # (..., ncol, nbnd)
    m = _band_expand_matrix(lkp).astype(dtype)
    return jax.lax.dot_general(
        per_band, m, (((per_band.ndim - 1,), (0,)), ((), ())), precision=hp
    )


class LWSources(NamedTuple):
    lay_source: jax.Array  # (nlay, ncol, ngpt)
    lev_source: jax.Array  # (nlay+1, ncol, ngpt)
    sfc_source: jax.Array  # (ncol, ngpt)


class LWOptics(NamedTuple):
    tau: jax.Array       # (nlay, ncol, ngpt)
    sources: LWSources


class SWOptics(NamedTuple):
    tau: jax.Array  # (nlay, ncol, ngpt)
    ssa: jax.Array  # (nlay, ncol, ngpt)


def compute_planck_sources(lkp: GasLookup, as_: AtmosphericState, pfrac: jax.Array) -> LWSources:
    """Planck sources from the total-Planck table and per-g-point fractions.

    Mirrors the fused source loop in /root/reference/src/optics/Optics.jl:228-248:
    interior level sources are geometric means of the (level Planck x adjacent
    layers' planck fraction) pair; surface source uses layer 0's fraction.
    """
    nlay = as_.nlay
    planck_lay = _planck_bands_to_gpt(lkp, as_.t_lay)   # (nlay, ncol, ngpt)
    planck_lev = _planck_bands_to_gpt(lkp, as_.t_lev)   # (nlay+1, ncol, ngpt)
    planck_sfc = _planck_bands_to_gpt(lkp, as_.t_sfc)   # (ncol, ngpt)

    lay_source = planck_lay * pfrac
    # level 0: planck_lev[0] * pfrac[layer0]; interior i: planck_lev[i] *
    # sqrt(pfrac[i-1] * pfrac[i]); top: planck_lev[nlay] * pfrac[nlay-1]
    lev0 = planck_lev[0] * pfrac[0]
    interior = planck_lev[1:nlay] * jnp.sqrt(pfrac[:-1] * pfrac[1:])
    top = planck_lev[nlay] * pfrac[-1]
    lev_source = jnp.concatenate([lev0[None], interior, top[None]], axis=0)
    sfc_source = planck_sfc * pfrac[0]
    return LWSources(lay_source=lay_source, lev_source=lev_source, sfc_source=sfc_source)


def gas_optics_lw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> LWOptics:
    """LW gas optics: tau + Planck sources for all g-points, (nlay, ncol, ngpt).

    Fuses the reference's per-column driver loop
    (/root/reference/src/optics/Optics.jl:202-293) into dense batched ops.
    """
    pt = compute_pt_interp(lkp, as_.p_lay, as_.t_lay)
    eta = compute_eta_interp(lkp, as_.vmr, pt, node_mode=eta_node_mode)
    tau_major = compute_tau_major(lkp, as_.col_dry, pt, eta)
    tau_minor = compute_tau_minor(lkp, as_.vmr, as_.col_dry, as_.p_lay, as_.t_lay, pt, eta)
    tau = jnp.maximum(tau_major + tau_minor, 0.0)
    pfrac = compute_planck_fraction(lkp, pt, eta)
    sources = compute_planck_sources(lkp, as_, pfrac)
    return LWOptics(tau=tau, sources=sources)


def gas_optics_sw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> SWOptics:
    """SW gas optics: tau + Rayleigh single-scattering albedo, (nlay, ncol, ngpt).

    Mirrors /root/reference/src/optics/gas_optics.jl:197-231.
    """
    pt = compute_pt_interp(lkp, as_.p_lay, as_.t_lay)
    eta = compute_eta_interp(lkp, as_.vmr, pt, node_mode=eta_node_mode)
    tau_major = compute_tau_major(lkp, as_.col_dry, pt, eta)
    tau_minor = compute_tau_minor(lkp, as_.vmr, as_.col_dry, as_.p_lay, as_.t_lay, pt, eta)
    tau_ray = compute_tau_rayleigh(lkp, as_.vmr, as_.col_dry, pt, eta)
    tau = jnp.maximum(tau_major + tau_minor + tau_ray, 0.0)
    ssa = jnp.where(tau > 0.0, tau_ray / jnp.where(tau > 0.0, tau, 1.0), 0.0)
    return SWOptics(tau=tau, ssa=ssa)
