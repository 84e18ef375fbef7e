"""Independent scalar oracle for the RRTMGP k-distribution numerics.

A deliberately slow, per-(column, g-point, layer) pure-NumPy float64
implementation of the RRTMGP algorithm, written as straight scalar loops from
the algorithm specification (the RRTM-for-GCMs k-distribution: trilinear
table interpolation in (eta, temperature, log-pressure), binary-species
eta parameter with col_mix scaling, minor-gas density/complement scaling
laws, Rayleigh scattering, Planck fraction/sources; transport: Clough-1992
linear-in-tau source integration, Meador-Weaver-1980 two-stream with
Toon-1989 LW sources and Shonk-Hogan-2008 adding, Zdunkowski-PIFM SW).

It deliberately shares NO code or vectorization structure with
rrtmgp_tpu.ops.* (no batching, no one-hot contractions, no scans): every
quantity is computed per scalar (layer, column, g-point) with explicit
Python loops, so an index-offset / axis-permutation / vectorization bug in
the batched XLA path cannot also be present here. The batched path must
match this oracle to ~1e-13 relative in f64, and to f32 tolerance in f32.

Spec anchors (semantics replicated, code NOT consulted for structure):
- interpolation index/fraction rules: /root/reference/src/optics/gas_optics.jl:82-150
  and optics_utils.jl:123-149 (incl. the eta endpoint convention: the
  fraction comes from the UNclamped truncation, so eta == 1 lands entirely
  on node n_eta-2)
- minor-gas scaling laws: /root/reference/src/optics/gas_optics.jl:255-306
- Planck source construction: /root/reference/src/optics/Optics.jl:228-248
- transport recurrences: /root/reference/src/rte/longwave1scalar.jl:149-212,
  longwave2stream.jl:110-253, shortwave2stream.jl:135-311
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrtmgp_tpu.angular import angular_discretization
from rrtmgp_tpu.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu.ops import rte
from rrtmgp_tpu.ops.gas_optics import gas_optics_lw, gas_optics_sw

# ---------------------------------------------------------------------------
# Scalar oracle: gas optics
# ---------------------------------------------------------------------------


def _np_lookup(lkp):
    """Materialize lookup arrays as plain NumPy f64 once."""
    f = lambda x: None if x is None else np.asarray(x, np.float64)
    return {
        "kmajor": f(lkp.kmajor),
        "kminor_lower": f(lkp.kminor_lower),
        "kminor_upper": f(lkp.kminor_upper),
        "eta_half": f(lkp.eta_half),
        "planck_fraction": f(lkp.planck_fraction),
        "totplnk": f(lkp.totplnk),
        "rayl": f(lkp.rayl),
    }


def _vmr_at(atm, ig, l, c):
    """Scalar VMR of 1-based gas ``ig`` at (layer l, column c).

    VmrGM convention: 0 -> 1.0, 1 -> 2-D h2o, 3 -> 2-D o3, else global mean.
    """
    if ig == 0:
        return 1.0
    if ig == 1:
        return float(atm.vmr.vmr_h2o[l, c])
    if ig == 3:
        return float(atm.vmr.vmr_o3[l, c])
    return float(atm.vmr.vmr[ig])


def _pt_index(lkp, p, t):
    """Scalar temperature/pressure interpolation data for one (layer, col).

    Temperature grid is uniform in T; pressure grid uniform in ln p
    (decreasing p). Indices clamp to the grid interior; fractions are NOT
    clamped (extrapolation off-grid, as the reference does).
    """
    loc_t = (t - lkp.t_ref_min) / lkp.t_ref_delta
    jt = int(min(max(math.floor(loc_t), 0), lkp.n_temp - 2))
    ft = loc_t - jt
    loc_p = (lkp.ln_p_ref_max - math.log(p)) / lkp.ln_p_ref_delta
    jp = int(min(max(math.floor(loc_p), 0), lkp.n_press - 2))
    fp = loc_p - jp
    lower = p > lkp.p_ref_tropo
    return jt, ft, jp, fp, lower


def _eta_index(lkp, tabs, atm, b, jt, lower, l, c, node_mode="continuous"):
    """Scalar eta data for band b at one (layer, column): for each of the two
    bracketing temperature nodes, (jeta, feta, col_mix).

    eta = vmr1 / (vmr1 + eta_half * vmr2), with eta_half the key-species
    reference-VMR ratio at that temperature node; col_mix = vmr1 +
    eta_half * vmr2 scales the corresponding temperature half of the major
    interpolation. eta fraction convention (node_mode, mirroring
    ops/gas_optics.ETA_NODE_MODES): "continuous" = f = loc - CLAMPED index —
    at eta exactly 1 the value comes entirely from node n_eta-1, keeping the
    interpolation continuous; "reference" = f = frac(loc) like the reference
    (gas_optics.jl:134-136), which jumps a full cell at exact grid nodes.
    """
    slot = 0 if lower else 1
    ig1, ig2 = lkp.key_species[b][slot]
    vmr1 = _vmr_at(atm, ig1, l, c)
    vmr2 = _vmr_at(atm, ig2, l, c)
    out = []
    for h in (0, 1):
        eta_half = tabs["eta_half"][b, slot, jt + h]
        col_mix = vmr1 + eta_half * vmr2
        eta = vmr1 / col_mix if col_mix > 0.0 else 0.5
        loc = eta * (lkp.n_eta - 1)
        je = int(min(math.floor(loc), lkp.n_eta - 2))
        fe = (loc - je) if node_mode == "continuous" else (loc - math.floor(loc))
        out.append((je, fe, col_mix))
    return out


def _band_of(lkp, g):
    for b, (g0, g1) in enumerate(lkp.bnd_lims_gpt):
        if g0 <= g < g1:
            return b
    raise AssertionError(g)


def oracle_gas_optics(lkp, atm, longwave, node_mode="continuous"):
    """Scalar-loop gas optics.

    Returns (tau, ssa_or_None, pfrac_or_None), each (nlay, ncol, ngpt) f64.
    tau = max(tau_major + tau_minor [+ tau_rayleigh], 0);
    ssa = tau_ray / tau (SW); pfrac from the Planck-fraction table (LW).
    """
    tabs = _np_lookup(lkp)
    nlay, ncol = atm.p_lay.shape
    ngpt = lkp.n_gpt
    p_lay = np.asarray(atm.p_lay, np.float64)
    t_lay = np.asarray(atm.t_lay, np.float64)
    col_dry = np.asarray(atm.col_dry, np.float64)

    tau = np.zeros((nlay, ncol, ngpt))
    ray = np.zeros((nlay, ncol, ngpt))
    pfrac = np.zeros((nlay, ncol, ngpt))

    for l in range(nlay):
        for c in range(ncol):
            p, t, cd = p_lay[l, c], t_lay[l, c], col_dry[l, c]
            jt, ft, jp, fp, lower = _pt_index(lkp, p, t)
            jpb = jp + (0 if lower else 1)  # kmajor press axis has npress+1 slabs
            vmr_h2o = _vmr_at(atm, lkp.idx_h2o, l, c)
            eta_by_band = {
                b: _eta_index(lkp, tabs, atm, b, jt, lower, l, c, node_mode)
                for b in range(lkp.n_bnd)
            }
            for g in range(ngpt):
                b = _band_of(lkp, g)
                eta2 = eta_by_band[b]
                # --- tau_major: trilinear (press, temp, eta) with per-temp
                # col_mix scaling, x col_dry
                acc = 0.0
                pfr = 0.0
                for h in (0, 1):
                    wt = ft if h == 1 else 1.0 - ft
                    je, fe, cm = eta2[h]
                    for ps in (0, 1):
                        wp = fp if ps == 1 else 1.0 - fp
                        K = tabs["kmajor"][g, jpb + ps, jt + h]
                        v = (1.0 - fe) * K[je] + fe * K[je + 1]
                        acc += wt * wp * cm * v
                        if longwave:
                            P = tabs["planck_fraction"][g, jpb + ps, jt + h]
                            pv = (1.0 - fe) * P[je] + fe * P[je + 1]
                            pfr += wt * wp * pv
                tau_g = acc * cd
                # --- tau_minor: intervals on this side of the troposphere
                intervals = lkp.minor_lower if lower else lkp.minor_upper
                kminor = tabs["kminor_lower"] if lower else tabs["kminor_upper"]
                for itv in intervals:
                    if itv.gas == 0 or not (itv.gpt0 <= g < itv.gpt1):
                        continue
                    scaling = _vmr_at(atm, itv.gas, l, c) * cd
                    if itv.scales_with_density:
                        scaling *= 0.01 * p / t
                        if itv.scaling_gas > 0:
                            sg = _vmr_at(atm, itv.scaling_gas, l, c)
                            frac = sg / (1.0 + vmr_h2o)
                            scaling *= (1.0 - frac) if itv.scale_by_complement else frac
                    bi = _band_of(lkp, itv.gpt0)  # eta of the interval's band
                    e2 = eta_by_band[bi]
                    row = kminor[itv.k0 + (g - itv.gpt0)]  # (ntemp, neta)
                    kval = 0.0
                    for h in (0, 1):
                        wt = ft if h == 1 else 1.0 - ft
                        je, fe, _ = e2[h]
                        kval += wt * ((1.0 - fe) * row[jt + h, je] + fe * row[jt + h, je + 1])
                    tau_g += kval * scaling
                tau[l, c, g] = tau_g
                if longwave:
                    pfrac[l, c, g] = pfr
                else:
                    # --- Rayleigh: (tropo, gpt, temp, eta), x (1+h2o)*col_dry
                    R = tabs["rayl"][0 if lower else 1, g]
                    kr = 0.0
                    for h in (0, 1):
                        wt = ft if h == 1 else 1.0 - ft
                        je, fe, _ = eta_by_band[b][h]
                        kr += wt * ((1.0 - fe) * R[jt + h, je] + fe * R[jt + h, je + 1])
                    ray[l, c, g] = kr * (1.0 + vmr_h2o) * cd

    if longwave:
        tau = np.maximum(tau, 0.0)
        return tau, None, pfrac
    tau_tot = np.maximum(tau + ray, 0.0)
    ssa = np.where(tau_tot > 0.0, ray / np.where(tau_tot > 0.0, tau_tot, 1.0), 0.0)
    return tau_tot, ssa, None


def _oracle_planck_band(lkp, tabs, tval, b):
    """interp1d on totplnk[:, b], equispaced grid, endpoint-clamped."""
    tp = tabs["totplnk"][:, b]
    n = tp.shape[0]
    t_max = lkp.t_planck_min + (n - 1) * lkp.t_planck_delta
    if tval < lkp.t_planck_min:
        return tp[0]
    if tval > t_max:
        return tp[-1]
    loc = (tval - lkp.t_planck_min) / lkp.t_planck_delta
    j = int(min(max(math.floor(loc), 0), n - 2))
    f = loc - j
    return tp[j] * (1.0 - f) + tp[j + 1] * f


def oracle_planck_sources(lkp, atm, pfrac):
    """Scalar Planck sources: layer, level (geometric-mean interior), surface.

    lev_source[0]   = B(t_lev[0])   * pfrac[layer 0]
    lev_source[i]   = B(t_lev[i])   * sqrt(pfrac[i-1] * pfrac[i])
    lev_source[top] = B(t_lev[top]) * pfrac[top layer]
    sfc_source      = B(t_sfc)      * pfrac[layer 0]
    """
    tabs = _np_lookup(lkp)
    nlay, ncol, ngpt = pfrac.shape
    t_lay = np.asarray(atm.t_lay, np.float64)
    t_lev = np.asarray(atm.t_lev, np.float64)
    t_sfc = np.asarray(atm.t_sfc, np.float64)
    lay = np.zeros((nlay, ncol, ngpt))
    lev = np.zeros((nlay + 1, ncol, ngpt))
    sfc = np.zeros((ncol, ngpt))
    for c in range(ncol):
        for g in range(ngpt):
            b = _band_of(lkp, g)
            for l in range(nlay):
                lay[l, c, g] = _oracle_planck_band(lkp, tabs, t_lay[l, c], b) * pfrac[l, c, g]
            lev[0, c, g] = _oracle_planck_band(lkp, tabs, t_lev[0, c], b) * pfrac[0, c, g]
            for i in range(1, nlay):
                lev[i, c, g] = _oracle_planck_band(lkp, tabs, t_lev[i, c], b) * math.sqrt(
                    pfrac[i - 1, c, g] * pfrac[i, c, g]
                )
            lev[nlay, c, g] = (
                _oracle_planck_band(lkp, tabs, t_lev[nlay, c], b) * pfrac[nlay - 1, c, g]
            )
            sfc[c, g] = _oracle_planck_band(lkp, tabs, t_sfc[c], b) * pfrac[0, c, g]
    return lay, lev, sfc


# ---------------------------------------------------------------------------
# Scalar oracle: transport sweeps (per (column, g-point), explicit loops)
# ---------------------------------------------------------------------------

_EPS64 = float(np.finfo(np.float64).eps)


def oracle_lw_noscat(tau, lay_src, lev_src, sfc_src, sfc_emis, Ds, w_mu, inc=None):
    """Clough-1992 linear-in-tau source integration, one angle.

    Downward then upward first-order recurrences; fact = (1-T)/tau - T with a
    3-term Taylor series below tau_thresh = 100 eps.
    """
    nlay, nb = tau.shape
    i2f = math.pi * w_mu
    up = np.zeros((nlay + 1, nb))
    dn = np.zeros((nlay + 1, nb))
    thresh = 100.0 * _EPS64
    for k in range(nb):
        i_dn = (inc[k] / i2f) if inc is not None else 0.0
        dn[nlay, k] = i_dn * i2f
        trans = np.zeros(nlay)
        fact = np.zeros(nlay)
        for l in range(nlay):
            tl = tau[l, k] * Ds
            trans[l] = math.exp(-tl)
            if tl > thresh:
                fact[l] = (1.0 - trans[l]) / tl - trans[l]
            else:
                fact[l] = tl * (0.5 + tl * (-1.0 / 3.0 + tl * 0.125))
        for l in range(nlay - 1, -1, -1):
            src_dn = (1.0 - trans[l]) * lev_src[l, k] + 2.0 * fact[l] * (
                lay_src[l, k] - lev_src[l, k]
            )
            i_dn = trans[l] * i_dn + src_dn
            dn[l, k] = i_dn * i2f
        i_up = i_dn * (1.0 - sfc_emis[k]) + sfc_emis[k] * sfc_src[k]
        up[0, k] = i_up * i2f
        for l in range(nlay):
            src_up = (1.0 - trans[l]) * lev_src[l + 1, k] + 2.0 * fact[l] * (
                lay_src[l, k] - lev_src[l + 1, k]
            )
            i_up = trans[l] * i_up + src_up
            up[l + 1, k] = i_up * i2f
    return up, dn


def _adding_scalar(Rdif, Tdif, src_up, src_dn, alb_sfc, src_sfc, dn_top):
    """Shonk-Hogan 2008 adding for one column: bottom-up albedo/source, then
    top-down diffuse flux. Returns (flux_up, flux_dn_diffuse) at all levels."""
    nlay = Rdif.shape[0]
    albedo = np.zeros(nlay + 1)
    src = np.zeros(nlay + 1)
    albedo[0], src[0] = alb_sfc, src_sfc
    for l in range(nlay):
        denom = 1.0 / (1.0 - Rdif[l] * albedo[l])
        albedo[l + 1] = Rdif[l] + Tdif[l] * Tdif[l] * albedo[l] * denom
        src[l + 1] = src_up[l] + Tdif[l] * denom * (src[l] + albedo[l] * src_dn[l])
    dn = np.zeros(nlay + 1)
    dn[nlay] = dn_top
    for l in range(nlay - 1, -1, -1):
        denom = 1.0 / (1.0 - Rdif[l] * albedo[l])
        dn[l] = (Tdif[l] * dn[l + 1] + Rdif[l] * src[l] + src_dn[l]) * denom
    upf = dn * albedo + src
    return upf, dn


def oracle_lw_2stream(tau, ssa, g, lev_src, sfc_src, sfc_emis, inc=None):
    """Meador-Weaver diffuse R/T + Toon-1989 linear-in-tau sources + adding."""
    nlay, nb = tau.shape
    k_min = _EPS64**0.5
    thresh = 100.0 * _EPS64
    up = np.zeros((nlay + 1, nb))
    dn = np.zeros((nlay + 1, nb))
    for c in range(nb):
        Rd = np.zeros(nlay)
        Td = np.zeros(nlay)
        su = np.zeros(nlay)
        sd = np.zeros(nlay)
        for l in range(nlay):
            g1 = 1.66 * (1.0 - 0.5 * ssa[l, c] * (1.0 + g[l, c]))
            g2 = 1.66 * 0.5 * ssa[l, c] * (1.0 - g[l, c])
            k = math.sqrt(max((g1 + g2) * (g1 - g2), k_min))
            co = math.exp(-2.0 * tau[l, c] * k)
            rt = 1.0 / (k * (1.0 + co) + g1 * (1.0 - co))
            Rd[l] = rt * g2 * (1.0 - co)
            Td[l] = rt * 2.0 * k * math.exp(-tau[l, c] * k)
            if tau[l, c] > thresh:
                lb, lt = lev_src[l, c], lev_src[l + 1, c]
                Z = (lb - lt) / (tau[l, c] * (g1 + g2))
                su[l] = math.pi * ((Z + lt) - Rd[l] * (-Z + lt) - Td[l] * (Z + lb))
                sd[l] = math.pi * ((-Z + lb) - Rd[l] * (Z + lb) - Td[l] * (-Z + lt))
        alb_sfc = 1.0 - sfc_emis[c]
        src_sfc = math.pi * sfc_emis[c] * sfc_src[c]
        dn_top = inc[c] if inc is not None else 0.0
        up[:, c], dn[:, c] = _adding_scalar(Rd, Td, su, sd, alb_sfc, src_sfc, dn_top)
    return up, dn


def oracle_sw_2stream(tau, ssa, g, mu0, toa, alb_dir, alb_dif, inc_dif=None):
    """Zdunkowski-PIFM gammas, Meador-Weaver direct R/T with energy clamps,
    cumulative-tau direct beam, adding for the diffuse field."""
    nlay, nb = tau.shape
    k_min = _EPS64**0.5
    up = np.zeros((nlay + 1, nb))
    dn = np.zeros((nlay + 1, nb))
    dndir = np.zeros((nlay + 1, nb))
    for c in range(nb):
        mu = mu0[c]
        mu_safe = max(mu, _EPS64)
        # direct beam: level i sees the optical depth of all layers above it
        dndir[nlay, c] = toa[c] * mu
        tsum = 0.0
        tau_above = np.zeros(nlay + 1)
        for l in range(nlay - 1, -1, -1):
            tsum += tau[l, c]
            tau_above[l] = tsum
        for l in range(nlay + 1):
            dndir[l, c] = toa[c] * mu * math.exp(-tau_above[l] / mu_safe)
        Rd = np.zeros(nlay)
        Td = np.zeros(nlay)
        su = np.zeros(nlay)
        sd = np.zeros(nlay)
        for l in range(nlay):
            w, ga = ssa[l, c], g[l, c]
            g1 = (8.0 - w * (5.0 + 3.0 * ga)) * 0.25
            g2 = 3.0 * (w * (1.0 - ga)) * 0.25
            g3 = (2.0 - (3.0 * mu) * ga) * 0.25
            g4 = 1.0 - g3
            a1 = g1 * g4 + g2 * g3
            a2 = g1 * g3 + g2 * g4
            k = math.sqrt(max((g1 - g2) * (g1 + g2), k_min))
            e1 = math.exp(-tau[l, c] * k)
            e2 = e1 * e1
            rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
            Rd[l] = rt * g2 * (1.0 - e2)
            Td[l] = rt * 2.0 * k * e1
            T0 = math.exp(-tau[l, c] / mu_safe)
            kmu, kg3, kg4 = k * mu, k * g3, k * g4
            om = 1.0 - kmu * kmu
            om = om if abs(om) >= _EPS64 else _EPS64
            rt2 = w * rt / om
            Rdir = rt2 * (
                (1.0 - kmu) * (a2 + kg3)
                - (1.0 + kmu) * (a2 - kg3) * e2
                - 2.0 * (kg3 - a2 * kmu) * e1 * T0
            )
            Tdir = -rt2 * (
                (1.0 + kmu) * (a1 + kg4) * T0
                - (1.0 - kmu) * (a1 - kg4) * e2 * T0
                - 2.0 * (kg4 + a1 * kmu) * e1
            )
            Rdir = max(0.0, min(Rdir, 1.0 - T0))
            Tdir = max(0.0, min(Tdir, 1.0 - T0 - Rdir))
            # direct source uses the beam entering the layer TOP (level l+1)
            su[l] = Rdir * dndir[l + 1, c]
            sd[l] = Tdir * dndir[l + 1, c]
        src_sfc = dndir[0, c] * alb_dir[c]
        dn_top = inc_dif[c] if inc_dif is not None else 0.0
        upf, dnf = _adding_scalar(Rd, Td, su, sd, alb_dif[c], src_sfc, dn_top)
        up[:, c] = upf
        dn[:, c] = dnf + dndir[:, c]
    return up, dn, dndir


# ---------------------------------------------------------------------------
# Tests: batched XLA path vs oracle (f64 ~1e-13, f32 to f32 tolerance)
# ---------------------------------------------------------------------------

NCOL, NLAY, NGPT, NBND = 4, 8, 16, 2


@pytest.fixture(scope="module")
def problem():
    lkp_lw = synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND)
    lkp_sw = synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1)
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY)
    return lkp_lw, lkp_sw, atm


def test_oracle_gas_optics_lw(problem):
    """XLA LW optics (tau, Planck fraction via sources) vs the scalar oracle."""
    lkp_lw, _, atm = problem
    optics = jax.jit(lambda a: gas_optics_lw(lkp_lw, a))(atm)
    tau_o, _, pfrac_o = oracle_gas_optics(lkp_lw, atm, longwave=True)
    np.testing.assert_allclose(np.asarray(optics.tau), tau_o, rtol=5e-13, atol=1e-300)
    lay_o, lev_o, sfc_o = oracle_planck_sources(lkp_lw, atm, pfrac_o)
    np.testing.assert_allclose(np.asarray(optics.sources.lay_source), lay_o, rtol=5e-13)
    np.testing.assert_allclose(np.asarray(optics.sources.lev_source), lev_o, rtol=5e-13)
    np.testing.assert_allclose(np.asarray(optics.sources.sfc_source), sfc_o, rtol=5e-13)


def test_oracle_gas_optics_sw(problem):
    """XLA SW optics (tau incl. Rayleigh, ssa) vs the scalar oracle."""
    _, lkp_sw, atm = problem
    optics = jax.jit(lambda a: gas_optics_sw(lkp_sw, a))(atm)
    tau_o, ssa_o, _ = oracle_gas_optics(lkp_sw, atm, longwave=False)
    np.testing.assert_allclose(np.asarray(optics.tau), tau_o, rtol=5e-13)
    np.testing.assert_allclose(np.asarray(optics.ssa), ssa_o, rtol=5e-13)


def _rand_optics(seed, nb, scattering):
    rng = np.random.default_rng(seed)
    tau = np.abs(rng.normal(0.4, 0.3, (NLAY, nb))) + 1e-4
    # include optically-thin layers to hit the Taylor/threshold branches
    tau[1] = 1e-15
    tau[3] = 5e-7
    if not scattering:
        return tau, None, None
    ssa = np.clip(rng.uniform(0.05, 0.95, (NLAY, nb)), 0.0, 1.0)
    g = np.clip(rng.uniform(0.0, 0.8, (NLAY, nb)), 0.0, 1.0)
    return tau, ssa, g


def test_oracle_lw_noscat_sweep():
    """XLA LW no-scat transport vs the scalar Clough recurrence, incl. the
    small-tau Taylor branch and TOA incident flux."""
    nb = 6
    tau, _, _ = _rand_optics(11, nb, scattering=False)
    rng = np.random.default_rng(12)
    lay = np.abs(rng.normal(30.0, 5.0, (NLAY, nb)))
    lev = np.abs(rng.normal(30.0, 5.0, (NLAY + 1, nb)))
    sfc = np.abs(rng.normal(35.0, 5.0, nb))
    emis = rng.uniform(0.8, 1.0, nb)
    inc = np.abs(rng.normal(2.0, 0.5, nb))
    Ds, w = angular_discretization(1)
    Ds, w = float(Ds[0]), float(w[0])
    up, dn = jax.jit(
        lambda *a: rte.lw_noscat(*a, Ds=Ds, w_mu=w, inc_flux=jnp.asarray(inc))
    )(*map(jnp.asarray, (tau, lay, lev, sfc, emis)))
    up_o, dn_o = oracle_lw_noscat(tau, lay, lev, sfc, emis, Ds, w, inc)
    np.testing.assert_allclose(np.asarray(up), up_o, rtol=1e-13)
    np.testing.assert_allclose(np.asarray(dn), dn_o, rtol=1e-13)


def test_oracle_lw_2stream_sweep():
    """XLA LW two-stream (Meador-Weaver + Toon + adding) vs scalar oracle."""
    nb = 6
    tau, ssa, g = _rand_optics(21, nb, scattering=True)
    rng = np.random.default_rng(22)
    lev = np.abs(rng.normal(30.0, 5.0, (NLAY + 1, nb)))
    sfc = np.abs(rng.normal(35.0, 5.0, nb))
    emis = rng.uniform(0.8, 1.0, nb)
    inc = np.abs(rng.normal(2.0, 0.5, nb))
    up, dn = jax.jit(
        lambda *a: rte.lw_2stream(*a, inc_flux=jnp.asarray(inc))
    )(*map(jnp.asarray, (tau, ssa, g, lev, sfc, emis)))
    up_o, dn_o = oracle_lw_2stream(tau, ssa, g, lev, sfc, emis, inc)
    # 2e-10: f64 roundoff through exp/sqrt + the adding recurrence's
    # 1/(1-R*albedo) denominators amplifies the last-bit differences between
    # XLA's fused FMAs and the plain-Python evaluation order (measured 6e-11)
    np.testing.assert_allclose(np.asarray(up), up_o, rtol=2e-10)
    np.testing.assert_allclose(np.asarray(dn), dn_o, rtol=2e-10)


def test_oracle_sw_2stream_sweep():
    """XLA SW two-stream (PIFM + direct source + adding) vs scalar oracle,
    including grazing sun angles and diffuse incident flux."""
    nb = 6
    tau, ssa, g = _rand_optics(31, nb, scattering=True)
    rng = np.random.default_rng(32)
    mu0 = np.array([0.9, 0.6, 0.3, 0.05, 1.0, 0.72])
    toa = np.abs(rng.normal(1361.0, 30.0, nb))
    alb_dir = rng.uniform(0.05, 0.5, nb)
    alb_dif = rng.uniform(0.05, 0.5, nb)
    inc_dif = np.abs(rng.normal(5.0, 1.0, nb))
    up, dn, dndir = jax.jit(
        lambda *a: rte.sw_2stream(*a, inc_flux_diffuse=jnp.asarray(inc_dif))
    )(*map(jnp.asarray, (tau, ssa, g, mu0, toa, alb_dir, alb_dif)))
    up_o, dn_o, dndir_o = oracle_sw_2stream(tau, ssa, g, mu0, toa, alb_dir, alb_dif, inc_dif)
    np.testing.assert_allclose(np.asarray(up), up_o, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(dn), dn_o, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(dndir), dndir_o, rtol=1e-12)


def test_eta_node_mode_on_node(problem):
    """Both eta node modes (ops/gas_optics.ETA_NODE_MODES) pinned against the
    scalar oracle on an atmosphere that lands eta EXACTLY on the top grid
    node: co2 (the second key species of every synthetic band's lower
    troposphere) set to 0 makes eta = 1 wherever tropo_lower. The continuous
    mode must read node n_eta-1, the reference mode node n_eta-2 — the two
    must each match their oracle at 5e-13 and genuinely differ from each
    other (the full-cell jump of ref gas_optics.jl:134-136)."""
    import dataclasses

    lkp_lw, _, atm0 = problem
    atm = dataclasses.replace(
        atm0, vmr=dataclasses.replace(atm0.vmr, vmr=atm0.vmr.vmr.at[2].set(0.0))
    )
    taus = {}
    for mode in ("continuous", "reference"):
        optics = jax.jit(
            lambda a, m=mode: gas_optics_lw(lkp_lw, a, eta_node_mode=m)
        )(atm)
        tau_o, _, _ = oracle_gas_optics(lkp_lw, atm, longwave=True, node_mode=mode)
        np.testing.assert_allclose(
            np.asarray(optics.tau), tau_o, rtol=5e-13, atol=1e-300
        )
        taus[mode] = tau_o
    # the modes must actually diverge here (eta == 1 reads different nodes)
    rel = np.max(
        np.abs(taus["continuous"] - taus["reference"])
        / np.maximum(taus["continuous"], 1e-300)
    )
    assert rel > 1e-3, rel
    # and stay bitwise identical off-node (the unmodified atmosphere)
    for mode in ("continuous", "reference"):
        t = jax.jit(
            lambda a, m=mode: gas_optics_lw(lkp_lw, a, eta_node_mode=m).tau
        )(atm0)
        taus[f"off_{mode}"] = np.asarray(t)
    np.testing.assert_array_equal(taus["off_continuous"], taus["off_reference"])


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_oracle_optics_f32(problem, longwave):
    """The XLA optics path in f32 vs the f64 scalar oracle at f32 tolerance —
    the precision every f32 solve runs at (including the GPU's, where a
    product computed in TF32 would miss this bound)."""
    lkp_lw, lkp_sw, atm64 = problem
    lkp64 = lkp_lw if longwave else lkp_sw
    lkp32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "dtype") else x, lkp64
    )
    atm32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        atm64,
    )
    fn = gas_optics_lw if longwave else gas_optics_sw
    optics = jax.jit(lambda a: fn(lkp32, a))(atm32)
    assert optics.tau.dtype == jnp.float32
    tau_o, ssa_o, _ = oracle_gas_optics(lkp64, atm64, longwave=longwave)
    np.testing.assert_allclose(np.asarray(optics.tau), tau_o, rtol=3e-4, atol=1e-9)
    if not longwave:
        np.testing.assert_allclose(np.asarray(optics.ssa), ssa_o, rtol=3e-4, atol=1e-7)
