"""Gray-atmosphere radiation model.

Analytic optical-thickness gray radiation: the framework's zero-data model
family, mirroring the reference's gray path
(/root/reference/src/optics/gray_atmospheric_states.jl,
 /root/reference/src/optics/gray_optics_kernels.jl,
 /root/reference/src/optics/GrayUtils.jl) as pure JAX functions.

Array layout: vertical axis leading, columns trailing — (nlay, ncol) /
(nlay+1, ncol) — so vertical scans run over the leading axis and columns are
contiguous. Level 0 is the surface.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..angular import angular_discretization
from ..ops import rte
from ..parameters import RRTMGPParameters, pow_fast
from ..utils.pytree import pytree_dataclass


# ---------------------------------------------------------------------------
# Optical-thickness parameterizations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrayOpticalThicknessSchneider2004:
    """Schneider 2004 (JAS 61, 1317) gray LW optical-thickness parameters.

    Ref /root/reference/src/optics/gray_atmospheric_states.jl:13-26.
    """

    alpha: float = 3.5  # lapse-rate exponent
    te: float = 300.0   # global-mean surface temperature [K]
    tt: float = 200.0   # TOA skin temperature [K]
    dt: float = 60.0    # equator-pole temperature difference [K]


@dataclasses.dataclass(frozen=True)
class GrayOpticalThicknessOGorman2008:
    """O'Gorman 2008 (J. Climate 21, 3815) gray optical-thickness parameters.

    Ref /root/reference/src/optics/gray_atmospheric_states.jl:37-52.
    """

    alpha: float = 1.0   # scaling factor
    fl: float = 0.2      # linear-term weight
    tau_e: float = 7.2   # LW optical thickness at equator
    tau_p: float = 1.8   # LW optical thickness at poles
    tau_0: float = 0.22  # SW optical thickness


GrayOpticalThickness = GrayOpticalThicknessSchneider2004 | GrayOpticalThicknessOGorman2008


def _deg2rad(lat):
    return lat * (jnp.pi / 180.0)


def gray_tau_lw(otp: GrayOpticalThickness, p0, dp, p, lat):
    """Gray LW layer optical thickness (vectorized).

    Ref /root/reference/src/optics/gray_optics_kernels.jl:148-183.
    """
    if isinstance(otp, GrayOpticalThicknessSchneider2004):
        ts_by_tt = (otp.te + otp.dt * (1.0 / 3.0 - jnp.sin(_deg2rad(lat)) ** 2)) / otp.tt
        d0 = ts_by_tt**4 - 1.0
        return jnp.abs((otp.alpha * d0 * pow_fast(p / p0, otp.alpha) / p) * dp)
    elif isinstance(otp, GrayOpticalThicknessOGorman2008):
        sigma = p / p0
        tau = (
            (otp.alpha * dp / p)
            * (otp.fl * sigma + (1.0 - otp.fl) * 4.0 * sigma**4)
            * (otp.tau_e + (otp.tau_p - otp.tau_e) * jnp.sin(_deg2rad(lat)) ** 2)
        )
        return jnp.abs(tau)
    raise TypeError(f"unknown gray optical thickness parameterization: {otp!r}")


def gray_tau_sw(otp: GrayOpticalThickness, p0, dp, p, lat):
    """Gray SW layer optical thickness (vectorized).

    Ref /root/reference/src/optics/gray_optics_kernels.jl:160,198-202.
    """
    if isinstance(otp, GrayOpticalThicknessSchneider2004):
        return jnp.zeros_like(p)
    elif isinstance(otp, GrayOpticalThicknessOGorman2008):
        return jnp.abs(2.0 * otp.tau_0 * (p / p0) * (dp / p0))
    raise TypeError(f"unknown gray optical thickness parameterization: {otp!r}")


# ---------------------------------------------------------------------------
# Atmospheric state
# ---------------------------------------------------------------------------


@pytree_dataclass(meta_fields=("otp",))
class GrayAtmosphericState:
    """Gray atmospheric state (ref /root/reference/src/optics/gray_atmospheric_states.jl:64-87).

    Shapes: lat/t_sfc (ncol,), p_lay/t_lay (nlay, ncol), p_lev/t_lev/z_lev (nlay+1, ncol).
    """

    lat: jax.Array
    p_lay: jax.Array
    p_lev: jax.Array
    t_lay: jax.Array
    t_lev: jax.Array
    z_lev: jax.Array
    t_sfc: jax.Array
    otp: GrayOpticalThickness

    @property
    def nlay(self) -> int:
        return self.p_lay.shape[0]

    @property
    def ncol(self) -> int:
        return self.p_lay.shape[-1]


def setup_gray_as_pr_grid(
    nlay: int,
    lat: jax.Array,
    p0: float,
    pe: float,
    otp: GrayOpticalThickness,
    params: RRTMGPParameters,
    dtype=jnp.float32,
) -> GrayAtmosphericState:
    """Analytic Schneider-2004 radiative-equilibrium T/p profiles on a linear
    pressure grid (ref /root/reference/src/optics/gray_atmospheric_states.jl:167-216).
    """
    lat = jnp.asarray(lat, dtype)
    te, tt, dt, alpha = 300.0, 200.0, 60.0, 3.5

    ts = te + dt * (1.0 / 3.0 - jnp.sin(_deg2rad(lat)) ** 2)
    d0 = (ts / tt) ** 4 - 1.0  # (ncol,)

    dp = (p0 - pe) / nlay
    # levels: p0 - i*dp, i=0..nlay (level 0 = surface)
    ilev = jnp.arange(nlay + 1, dtype=dtype)
    p_lev_1d = p0 - ilev * dp
    p_lev = jnp.broadcast_to(p_lev_1d[:, None], (nlay + 1, lat.shape[0])).astype(dtype)
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])

    def temp(p):
        return tt * (1.0 + d0[None, :] * (p / p0) ** alpha) ** 0.25

    t_lev = temp(p_lev)
    t_lay = temp(p_lay)

    # Hydrostatic level altitudes
    H = params.R_d * t_lay / params.grav
    dz_lay = H * jnp.log(p_lev[:-1] / p_lev[1:])
    z_lev = jnp.concatenate(
        [jnp.zeros_like(dz_lay[:1]), jnp.cumsum(dz_lay, axis=0)], axis=0
    )
    t_sfc = t_lev[0]
    return GrayAtmosphericState(
        lat=lat,
        p_lay=p_lay.astype(dtype),
        p_lev=p_lev.astype(dtype),
        t_lay=t_lay.astype(dtype),
        t_lev=t_lev.astype(dtype),
        z_lev=z_lev.astype(dtype),
        t_sfc=t_sfc.astype(dtype),
        otp=otp,
    )


# ---------------------------------------------------------------------------
# Gray optics + Planck sources
# ---------------------------------------------------------------------------


def gray_optics_lw(as_: GrayAtmosphericState, params: RRTMGPParameters):
    """Gray LW optical depth + Planck sources (vectorized over all columns).

    Mirrors /root/reference/src/optics/gray_optics_kernels.jl:14-55: sigma*T^4/pi
    sources; interior level source is the geometric mean of the source computed
    from the level temperature seen from the layers below and above
    (both equal T_lev here, so sqrt(a*b) with a==b — kept for exact parity).
    """
    dtype = as_.p_lay.dtype
    sbc = dtype.type(params.Stefan)
    pi = dtype.type(jnp.pi)

    dp = as_.p_lev[1:] - as_.p_lev[:-1]
    p0 = as_.p_lev[0]
    tau = gray_tau_lw(as_.otp, p0[None, :], dp, as_.p_lay, as_.lat[None, :]).astype(dtype)

    def planck(t):
        return sbc * (t * t * t * t) / pi

    lay_source = planck(as_.t_lay)
    lev_src = planck(as_.t_lev)  # (nlev, ncol)
    # Interior levels: geometric mean of inc/dec sources (equal here); endpoints direct
    lev_source = jnp.concatenate(
        [lev_src[:1], jnp.sqrt(lev_src[1:-1] * lev_src[1:-1]), lev_src[-1:]], axis=0
    )
    sfc_source = planck(as_.t_sfc)
    return tau, lay_source, lev_source, sfc_source


def gray_optics_sw(as_: GrayAtmosphericState):
    """Gray SW optical depth (ref /root/reference/src/optics/gray_optics_kernels.jl:110-132)."""
    dp = as_.p_lev[1:] - as_.p_lev[:-1]
    p0 = as_.p_lev[0]
    return gray_tau_sw(as_.otp, p0[None, :], dp, as_.p_lay, as_.lat[None, :]).astype(
        as_.p_lay.dtype
    )


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def solve_gray_lw(
    as_: GrayAtmosphericState,
    sfc_emis: jax.Array,  # (ncol,)
    params: RRTMGPParameters = RRTMGPParameters(),
    inc_flux: jax.Array | None = None,
    two_stream: bool = False,
    n_gauss_angles: int = 1,
):
    """Gray LW solve; returns (flux_up, flux_dn, flux_net), each (nlay+1, ncol)."""
    tau, lay_source, lev_source, sfc_source = gray_optics_lw(as_, params)
    if two_stream:
        ssa = jnp.zeros_like(tau)
        g = jnp.zeros_like(tau)
        flux_up, flux_dn = rte.lw_2stream(
            tau, ssa, g, lev_source, sfc_source, sfc_emis, inc_flux
        )
    else:
        Ds, wts = angular_discretization(n_gauss_angles)
        flux_up, flux_dn = rte.lw_noscat(
            tau, lay_source, lev_source, sfc_source, sfc_emis,
            float(Ds[0]), float(wts[0]), inc_flux,
        )
    return flux_up, flux_dn, flux_up - flux_dn


def solve_gray_sw(
    as_: GrayAtmosphericState,
    cos_zenith: jax.Array,       # (ncol,)
    toa_flux: jax.Array,         # (ncol,)
    sfc_alb_direct: jax.Array | None = None,   # (ncol,) for two-stream
    sfc_alb_diffuse: jax.Array | None = None,  # (ncol,)
    inc_flux_diffuse: jax.Array | None = None,
    two_stream: bool = False,
):
    """Gray SW solve; returns (flux_up, flux_dn, flux_dn_dir, flux_net).

    Night columns (mu0 <= 0) are zeroed, as in the reference
    (/root/reference/src/rte/shortwave1scalar.jl:16-23).
    """
    tau = gray_optics_sw(as_)
    day = cos_zenith > 0

    if two_stream:
        ssa = jnp.zeros_like(tau)
        g = jnp.zeros_like(tau)
        flux_up, flux_dn, flux_dn_dir = rte.sw_2stream(
            tau, ssa, g, cos_zenith, toa_flux,
            sfc_alb_direct, sfc_alb_diffuse, inc_flux_diffuse,
        )
    else:
        flux_dn_dir = rte.sw_noscat(tau, cos_zenith, toa_flux)
        flux_up = jnp.zeros_like(flux_dn_dir)
        flux_dn = jnp.zeros_like(flux_dn_dir)

    mask = day[None, :]
    flux_up = jnp.where(mask, flux_up, 0.0)
    flux_dn = jnp.where(mask, flux_dn, 0.0)
    flux_dn_dir = jnp.where(mask, flux_dn_dir, 0.0)
    return flux_up, flux_dn, flux_dn_dir, flux_up - flux_dn


# ---------------------------------------------------------------------------
# Radiative-equilibrium utilities (the gray "training loop")
# ---------------------------------------------------------------------------


def compute_gray_heating_rate(flux_net, p_lev, params: RRTMGPParameters):
    """Heating rate from net-flux divergence (ref /root/reference/src/optics/GrayUtils.jl:146-153)."""
    return (
        params.grav
        * (flux_net[1:] - flux_net[:-1])
        / (p_lev[1:] - p_lev[:-1])
        / params.cp_d
    )


def update_profile_lw(t_lay, t_lev, flux_dn, flux_net, hr_lay, dt_sec, params: RRTMGPParameters):
    """One explicit timestep of the gray radiative-equilibrium iteration.

    Mirrors /root/reference/src/optics/GrayUtils.jl:67-111: update layer
    temperatures by the heating rate, rebuild level temperatures by the
    reference's one-sided interpolation stencil, and return the analytic
    equilibrium level temperature + flux-gradient convergence measure.
    Returns (t_lay, t_lev, T_ex_lev, flux_grad).
    """
    nlay = t_lay.shape[0]
    sbc = params.Stefan

    t_lay = t_lay + dt_sec * hr_lay

    # Interior stencil: t_lev[i] = t_lay[i-1]/3 + 5/6 t_lay[i] - 1/6 t_lay[i+1]
    # for i in 1..nlay-2 (0-based), then the reference's special top/bottom rows.
    interior = (
        t_lay[:-2] / 3.0 + (5.0 / 6.0) * t_lay[1:-1] - (1.0 / 6.0) * t_lay[2:]
    )  # rows 1..nlay-2 of t_lev
    t_lev_nlaym1 = (
        t_lay[nlay - 1] / 3.0 + (5.0 / 6.0) * t_lay[nlay - 2] - (1.0 / 6.0) * t_lay[nlay - 3]
    )
    mid = jnp.concatenate([interior, t_lev_nlaym1[None]], axis=0)  # rows 1..nlay-1
    t_lev_0 = 2.0 * t_lay[0] - mid[0]
    t_lev_top = 2.0 * t_lay[nlay - 1] - mid[-1]
    t_lev = jnp.concatenate([t_lev_0[None], mid, t_lev_top[None]], axis=0)

    T_ex_lev = jnp.sqrt(jnp.sqrt((flux_dn + 0.5 * flux_net) / sbc))
    flux_grad = jnp.abs(flux_net[1:] - flux_net[:-1])
    return t_lay, t_lev, T_ex_lev, flux_grad


def gray_lw_equilibrium(
    as_: GrayAtmosphericState,
    sfc_emis: jax.Array,
    params: RRTMGPParameters = RRTMGPParameters(),
    dt_sec: float = 21600.0,
    max_steps: int = 58400,
    flux_grad_tol: float = 1e-5,
    two_stream: bool = False,
):
    """Iterate gray LW solve + profile update to radiative equilibrium.

    The whole loop runs under ``lax.while_loop`` in one compiled program
    (the reference's host loop: /root/reference/test/gray_atm_utils.jl:77-102).
    Returns (as_, T_ex_lev, flux_grad_err, n_steps).
    """
    dtype = as_.t_lay.dtype
    T_ex0 = jnp.zeros_like(as_.t_lev)

    def cond(state):
        _, _, err, step = state
        return jnp.logical_and(step < max_steps, err >= flux_grad_tol)

    def body(state):
        atm, _, _, step = state
        flux_up, flux_dn, flux_net = solve_gray_lw(
            atm, sfc_emis, params, two_stream=two_stream
        )
        hr_lay = compute_gray_heating_rate(flux_net, atm.p_lev, params)
        t_lay, t_lev, T_ex_lev, flux_grad = update_profile_lw(
            atm.t_lay, atm.t_lev, flux_dn, flux_net, hr_lay, dt_sec, params
        )
        atm = dataclasses.replace(atm, t_lay=t_lay, t_lev=t_lev)
        err = jnp.max(flux_grad).astype(dtype)
        return atm, T_ex_lev, err, step + 1

    init = (as_, T_ex0, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32))
    return jax.lax.while_loop(cond, body, init)
