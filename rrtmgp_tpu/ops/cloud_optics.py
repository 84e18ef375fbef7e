"""Cloud optics: LUT interpolation in effective radius + two-stream increment.

Mirrors /root/reference/src/optics/cloud_optics.jl (and optics_utils.jl's
increment_2stream/delta_scale), vectorized over (nlay, ncol) and applied per
band slice of the (nlay, ngpt, ncol) optics tensors. The cloud LUT varies per
*band*, not per g-point, so properties are computed once per band and
broadcast over that band's g-points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..data.lookups import CloudLookup
from ..states import CloudState


def _eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


def delta_scale(tau, ssa, g):
    """Delta-scaling of two-stream properties (ref optics_utils.jl:169-177)."""
    eps = _eps(tau.dtype)
    f = g * g
    wf = ssa * f
    tau_s = (1.0 - wf) * tau
    ssa_s = (ssa - wf) / jnp.maximum(eps, 1.0 - wf)
    g_s = (g - f) / jnp.maximum(eps, 1.0 - f)
    return tau_s, ssa_s, g_s


def increment_2stream(tau1, ssa1, g1, tau2, ssa2, g2):
    """Combine two-stream optical properties (ref optics_utils.jl:157-163)."""
    eps = _eps(tau1.dtype)
    tau = tau1 + tau2
    ssa_w = tau1 * ssa1 + tau2 * ssa2
    g_out = (tau1 * ssa1 * g1 + tau2 * ssa2 * g2) / jnp.maximum(eps, ssa_w)
    ssa_out = ssa_w / jnp.maximum(eps, tau)
    return tau, ssa_out, g_out


def _rad_interp(table, re, path, rad_lwr, rad_upr, nsize):
    """Linear interpolation of (ext, ssa, asy) vs effective radius.

    table: (3, nsize, ...) band-sliced LUT; re/path: (nlay, ncol).
    Returns (tau, tau*ssa, tau*ssa*g), zero where path <= eps
    (ref cloud_optics.jl:145-213).
    """
    dtype = re.dtype
    eps = _eps(dtype)
    dr = (rad_upr - rad_lwr) / (nsize - 1)
    re_c = jnp.clip(re, rad_lwr, rad_upr)
    loc = jnp.clip(jnp.floor((re_c - rad_lwr) / dr), 0, nsize - 2).astype(jnp.int32)
    fac = (re_c - rad_lwr - loc * dr) / dr
    fc1 = 1.0 - fac

    ext = fc1 * table[0, loc] + fac * table[0, loc + 1]
    ssa = fc1 * table[1, loc] + fac * table[1, loc + 1]
    asy = fc1 * table[2, loc] + fac * table[2, loc + 1]

    tau = jnp.maximum(ext * path, 0.0)
    tau_ssa = ssa * tau
    tau_ssag = asy * tau_ssa
    active = path > eps
    z = jnp.zeros_like(tau)
    return (
        jnp.where(active, tau, z),
        jnp.where(active, tau_ssa, z),
        jnp.where(active, tau_ssag, z),
    )


def cloud_optics_band(lkp: CloudLookup, cs: CloudState, ibnd: int):
    """Cloud two-stream properties (tau, ssa, g) for one band, (nlay, ncol)."""
    eps = _eps(cs.cld_path_liq.dtype)
    liq = lkp.liq[:, :, ibnd]                       # (3, nsize_liq)
    ice = lkp.ice[:, :, ibnd, cs.ice_rgh - 1]       # (3, nsize_ice)

    tl, tl_ssa, tl_ssag = _rad_interp(
        liq, cs.cld_r_eff_liq, cs.cld_path_liq, lkp.radliq_lwr, lkp.radliq_upr, lkp.nsize_liq
    )
    ti, ti_ssa, ti_ssag = _rad_interp(
        ice, cs.cld_r_eff_ice, cs.cld_path_ice, lkp.radice_lwr, lkp.radice_upr, lkp.nsize_ice
    )
    tau_c = tl + ti
    ssa_c = tl_ssa + ti_ssa
    g_c = (tl_ssag + ti_ssag) / jnp.maximum(eps, ssa_c)
    ssa_c = ssa_c / jnp.maximum(eps, tau_c)
    return tau_c, ssa_c, g_c


def _rad_interp_all_bands(table_all, re, path, rad_lwr, rad_upr, nsize):
    """All-band radius interpolation via ONE one-hot matmul.

    table_all: (3, nsize, nbnd). Instead of one pointwise ``table[0, loc]``
    gather per band and property, the tiny radius axis becomes a
    (rows, nsize) one-hot times (nsize, 3*nbnd) contraction that fetches
    every property for every band at once. Returns (tau, tau*ssa,
    tau*ssa*g), each (nlay, ncol, nbnd).
    """
    dtype = re.dtype
    eps = _eps(dtype)
    nlay, ncol = re.shape
    nbnd = table_all.shape[2]
    dr = (rad_upr - rad_lwr) / (nsize - 1)
    re_c = jnp.clip(re, rad_lwr, rad_upr)
    loc = jnp.clip(jnp.floor((re_c - rad_lwr) / dr), 0, nsize - 2).astype(jnp.int32)
    fac = ((re_c - rad_lwr - loc * dr) / dr).reshape(-1, 1)
    locf = loc.reshape(-1, 1)
    iota = jnp.arange(nsize, dtype=jnp.int32)
    w = jnp.where(iota == locf, 1.0 - fac, 0.0) + jnp.where(iota == locf + 1, fac, 0.0)
    lut2 = jnp.moveaxis(table_all.astype(dtype), 1, 0).reshape(nsize, 3 * nbnd)
    vals = jax.lax.dot_general(
        w.astype(dtype), lut2, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(nlay, ncol, 3, nbnd)
    ext, ssa, asy = vals[:, :, 0], vals[:, :, 1], vals[:, :, 2]

    tau = jnp.maximum(ext * path[:, :, None], 0.0)
    tau_ssa = ssa * tau
    tau_ssag = asy * tau_ssa
    active = (path > eps)[:, :, None]
    z = jnp.zeros_like(tau)
    return (
        jnp.where(active, tau, z),
        jnp.where(active, tau_ssa, z),
        jnp.where(active, tau_ssag, z),
    )


def cloud_optics_bands(lkp: CloudLookup, cs: CloudState):
    """Cloud two-stream properties for ALL bands: (tau, ssa, g), each
    (nlay, ncol, nbnd). One-hot-matmul formulation of
    ref cloud_optics.jl:145-213 (see _rad_interp_all_bands)."""
    eps = _eps(cs.cld_path_liq.dtype)
    tl, tl_ssa, tl_ssag = _rad_interp_all_bands(
        lkp.liq, cs.cld_r_eff_liq, cs.cld_path_liq,
        lkp.radliq_lwr, lkp.radliq_upr, lkp.nsize_liq,
    )
    ti, ti_ssa, ti_ssag = _rad_interp_all_bands(
        lkp.ice[:, :, :, cs.ice_rgh - 1], cs.cld_r_eff_ice, cs.cld_path_ice,
        lkp.radice_lwr, lkp.radice_upr, lkp.nsize_ice,
    )
    tau_c = tl + ti
    ssa_c = tl_ssa + ti_ssa
    g_c = (tl_ssag + ti_ssag) / jnp.maximum(eps, ssa_c)
    ssa_c = ssa_c / jnp.maximum(eps, tau_c)
    return tau_c, ssa_c, g_c


# ---------------------------------------------------------------------------
# McICA cloud-mask sampling
# ---------------------------------------------------------------------------


def build_cloud_mask_mcica(
    key: jax.Array,
    cld_frac: jax.Array,   # (nlay, ncol)
    n_gpt: int,
    col_offset: jax.Array | int | None = None,
) -> jax.Array:
    """Max-random-overlap McICA cloud mask, (nlay, ncol, ngpt) bool.

    Reimplements the reference's top-down sampler
    (/root/reference/src/optics/cloud_optics.jl:222-261) with counter-based
    ``jax.random`` keys — the reproducibility contract the reference gets from
    host RNG reseeding (reset_rng_seed, /root/reference/src/api/api_types.jl:75-85)
    comes from keying on (step, column, g-point) instead.

    With ``col_offset`` given (the global index of column 0 of this batch),
    each column draws from its own counter-based stream keyed on
    fold_in(key, global column index): the mask becomes a pure function of
    (key, global column), bitwise-invariant to column sharding (shard_map
    over a mesh) and chunking (solve_chunked). With col_offset=None the
    whole batch draws one monolithic block (slightly cheaper; layout-
    dependent values).

    Recurrence (top layer -> bottom, only over cloudy-fraction layers):
      mask[top_cloudy] = u[top] >= 1 - cf[top]
      below, if layer above cloudy: reuse its random number
             else: u = u_new * (1 - cf_above)
      mask = (cf > 0) & (u >= 1 - cf)
    Layers above/below the cloudy range are clear. cld_frac == 1 is
    deterministic (mask = True), matching the reference's test configs.
    """
    nlay, ncol = cld_frac.shape
    dtype = cld_frac.dtype
    if col_offset is None:
        u = jax.random.uniform(key, (nlay, ncol, n_gpt), dtype=dtype)
    else:
        cols = jnp.asarray(col_offset, jnp.int32) + jnp.arange(ncol, dtype=jnp.int32)
        keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(cols)
        u = jax.vmap(
            lambda k: jax.random.uniform(k, (nlay, n_gpt), dtype=dtype)
        )(keys)  # (ncol, nlay, ngpt)
        u = jnp.moveaxis(u, 0, 1)
    cf = cld_frac[:, :, None]  # broadcast over g-points

    # top-down scan over layers (reverse: start from TOA = last index)
    def step(carry, xs):
        u_above, mask_above, cf_above, started = carry
        u_i, cf_i = xs
        # first cloudy layer encountered uses its own random number;
        # below: reuse if layer above cloudy else rescale fresh draw
        u_eff = jnp.where(
            started,
            jnp.where(mask_above, u_above, u_i * (1.0 - cf_above)),
            u_i,
        )
        cloudy = cf_i > 0.0
        mask_i = jnp.logical_and(cloudy, u_eff >= (1.0 - cf_i))
        started_next = jnp.logical_or(started, cloudy)
        # layers with cf == 0 break the "reuse" chain exactly as the reference
        # (it restarts sampling below a clear layer via the else branch)
        return (u_eff, mask_i, cf_i, started_next), mask_i

    init = (
        jnp.zeros((ncol, n_gpt), dtype),
        jnp.zeros((ncol, n_gpt), bool),
        jnp.zeros((ncol, n_gpt), dtype),
        jnp.zeros((ncol, n_gpt), bool),
    )
    _, masks = jax.lax.scan(step, init, (u, jnp.broadcast_to(cf, u.shape)), reverse=True)
    return masks


def cloud_cover_from_mask(cld_mask: jax.Array) -> jax.Array:
    """McICA effective cloud cover per column: fraction of g-points with any
    cloudy layer (ref /root/reference/src/rte/shortwave2stream.jl:81-84,110-114)."""
    any_cloud = jnp.any(cld_mask, axis=0)  # (ncol, ngpt)
    return jnp.mean(any_cloud.astype(jnp.float32), axis=-1)
