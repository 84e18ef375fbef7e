"""Smoke test of the radiation solver on NVIDIA GPUs.

    python chip_smoke.py          # phases 0-6 on one GPU
    python chip_smoke.py --four   # only the column-mesh phase, on four GPUs

Everything runs in ONE process: the solves on the GPU, their references on
the host's CPU device. The solves go through the entry points a host model
calls (``RRTMGPSolver.update_fluxes``, ``advance_step``, the getters, and the
public ``solve_*`` functions) with synthetic lookup tables at full spectral
width (LW 256 g-points / 16 bands, SW 224 / 14, 60 layers); no data files
are needed.

Phases (one line each, JSON, before the last line):

0. device   — refuses to run unless JAX's first device is a GPU.
1. gray     — 4,096 x 60 gray LW: TOA downward flux = 0, surface upward
              flux = sigma T^4.
2. clear    — f32 LW no-scat + SW two-stream pair at 32,768 columns (the
              bench size), against CPU f32 and CPU f64 on 256 columns.
3. allsky   — f32 McICA two-stream pair at 9,469 columns against CPU f32;
              cloud cover bitwise.
4. aerosky  — phase 3 with MERRA aerosols.
5. f64      — native f64 clear pair at 11,332 columns, unchunked and
              through the solver's auto-chunk, against CPU f64.
6. grad     — jax.grad of the summed LW flux w.r.t. t_lay, 1,024 columns,
              against CPU f32 and CPU f64 on 256 columns.
mesh (--four only) — all-sky pair on a 4-GPU column mesh at 37,876 columns
              against one-GPU solves of each shard's columns.

The last line is ``{"ok": true, "device": {...}}`` only when every phase
passed; otherwise the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import traceback
import warnings
from functools import partial

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)  # phase 5; before any array exists
import jax.numpy as jnp

import rrtmgp_tpu as rt
from rrtmgp_tpu.data.synthetic import (
    synthetic_aerosol_lookup,
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu.states import tree_map_columns
from rrtmgp_tpu.utils.compile import enable_compile_cache
from rrtmgp_tpu.utils.device import NoGPUError, gpu_name_and_power_limit, require_gpu

#: GPU-vs-CPU flux tolerance at the same dtype [W/m^2]. Its only sources are
#: the order of summation (g-point reductions, XLA's per-device choice of
#: reduction and fusion strategy) and last-ulp differences of the elementwise
#: intrinsics: two f32 evaluations that differ only in those can differ by up
#: to the sum of their roundoff errors, and the CPU's own f32 roundoff against
#: f64 is 0.0085 (LW) / 0.0135 (SW) W/m^2 at full width (64 columns x 60
#: layers). A product computed in TF32 (10-bit mantissa) would miss it by
#: orders of magnitude.
TOL_ORDER_F32 = 0.03
#: the same for f64, relative to the largest flux
TOL_ORDER_F64_REL = 1e-9
#: f32 accuracy envelope of the reference (BASELINE.md: LW no-scat, SW)
ENVELOPE_F32 = {"lw": 0.05, "sw": 0.04}
#: gradient tolerance, relative to the largest |dF/dT|: f32 roundoff of a
#: reverse sweep through exp/log and the recurrences — the CPU's own f32
#: gradient is up to 5.5e-3 of that scale off the f64 one (16 g-points x 16
#: layers, tests/test_autodiff.py), so two f32 evaluations may differ by twice
#: that
TOL_GRAD_REL = 2e-2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase (FULL on the card; tests use tiny ones)."""

    nlay: int = 60
    lw: tuple = (256, 16)            # (g-points, bands)
    sw: tuple = (224, 14)
    gray_ncol: int = 4096            # BASELINE.md gray GPU size
    clear_ncol: tuple = (32768, 22663, 11332)  # bench size, then halvings of 90,650
    allsky_ncol: int = 9469          # smallest all-sky DYAMOND size (75,748 / 8)
    f64_ncol: int = 11332
    f64_chunk_gb: float = 8.0        # budget that makes phase 5 chunk
    grad_ncol: int = 1024
    mesh_ncol: int = 4 * 9469
    ncmp: int = 256                  # columns compared with the CPU
    steps: int = 5


FULL = Sizes()


# ---------------------------------------------------------------------------
# problem construction
# ---------------------------------------------------------------------------


def lookups(sz: Sizes, dtype, cloudy=False, aero=False) -> rt.LookupBundle:
    """Synthetic tables at the sizes' spectral widths (as rt.lookup_tables)."""
    (glw, blw), (gsw, bsw) = sz.lw, sz.sw
    b = dict(
        lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=glw, n_bnd=blw, dtype=dtype),
        lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=gsw, n_bnd=bsw, seed=1, dtype=dtype),
    )
    if cloudy:
        b["lookup_lw_cld"] = synthetic_cloud_lookup(n_bnd=blw, dtype=dtype)
        b["lookup_sw_cld"] = synthetic_cloud_lookup(n_bnd=bsw, seed=5, dtype=dtype)
    if aero:
        b["lookup_lw_aero"] = synthetic_aerosol_lookup(n_bnd=blw, dtype=dtype)
        b["lookup_sw_aero"] = synthetic_aerosol_lookup(n_bnd=bsw, seed=6, dtype=dtype)
    return rt.LookupBundle(**b)


def problem(sz: Sizes, ncol: int, dtype, cloudy=False, aero=False):
    """(atm, bcs_lw, bcs_sw) as NumPy-backed host data. Cloud fractions are
    scaled to 0.6 so that McICA sampling is genuinely stochastic."""
    with jax.default_device(jax.devices("cpu")[0]):
        atm = synthetic_atmosphere(
            ncol=ncol, nlay=sz.nlay, dtype=dtype, with_clouds=cloudy, with_aerosols=aero
        )
        if cloudy:
            cs = atm.cloud_state
            atm = dataclasses.replace(
                atm, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * 0.6)
            )
        full = lambda shape, v: jnp.full(shape, v, dtype)
        blw, bsw = sz.lw[1], sz.sw[1]
        # cos_zenith varies across columns and includes night columns
        mu0 = np.cos(np.linspace(0.0, 0.6 * np.pi, ncol)).astype(dtype)
        bcs_lw = rt.LwBCs(sfc_emis=full((blw, ncol), 0.98))
        bcs_sw = rt.SwBCs(
            cos_zenith=jnp.asarray(mu0),
            toa_flux=full((ncol,), 1361.0),
            sfc_alb_direct=full((bsw, ncol), 0.2),
            sfc_alb_diffuse=full((bsw, ncol), 0.2),
        )
    return atm, bcs_lw, bcs_sw


def cols(tree, ncol: int, lo: int, hi: int):
    """Columns [lo, hi) of every column leaf (trailing axis ncol)."""
    def leaf(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0 or x.shape[-1] != ncol:
            return x
        return x[..., lo:hi]

    return tree_map_columns(leaf, lambda x: x, tree)


def cast(tree, dtype):
    """Every floating leaf as ``dtype`` (the f64 reference of an f32 problem
    starts from the same rounded inputs); a LookupBundle field by field."""
    if isinstance(tree, rt.LookupBundle):
        return rt.LookupBundle(**{
            f.name: cast(getattr(tree, f.name), dtype) for f in dataclasses.fields(tree)
        })

    def leaf(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, dtype)
        return x

    with jax.default_device(jax.devices("cpu")[0]):
        return jax.tree_util.tree_map(leaf, tree)


def on(device, tree):
    return jax.device_put(tree, device)


def solver(method, sz, device, atm, bcs_lw, bcs_sw, lk, dtype, **kw):
    """RRTMGPSolver with its state on ``device`` (device None: the state
    stays where it is, e.g. sharded over a mesh). The tables are constants
    of the solver's programs and follow the state."""
    if device is not None:
        atm, bcs_lw, bcs_sw = on(device, (atm, bcs_lw, bcs_sw))
    with jax.default_device(device):
        gp = rt.RRTMGPGridParams(nlay=sz.nlay, ncol=int(atm.ncol), dtype=dtype)
        return rt.RRTMGPSolver(
            gp, method, rt.RRTMGPParameters(), bcs_lw, bcs_sw, atm, lookups=lk, **kw
        )


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys} if m is not None else {}


def peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def compile_update(s: rt.RRTMGPSolver) -> dict:
    """Compile seconds and memory_analysis of the update_fluxes program."""
    t0 = time.perf_counter()
    compiled = s.lower_update_fluxes().compile()
    return {"compile_s": time.perf_counter() - t0, "memory": memory(compiled)}


def drive(s: rt.RRTMGPSolver, steps: int, compiled: dict | None = None) -> dict:
    """compile_update(s), then update_fluxes() ``steps`` times after a first
    call; adds the first call's and the median step's seconds."""
    out = dict(compiled or compile_update(s))
    t0 = time.perf_counter()
    jax.block_until_ready(s.update_fluxes())
    out["first_call_s"] = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(s.update_fluxes())
        times.append(time.perf_counter() - t0)
    out["step_s_median"] = float(np.median(times))
    return out


def fluxes(s: rt.RRTMGPSolver, ncmp: int) -> dict:
    """Flux getters on the first ``ncmp`` columns, as float64 NumPy."""
    get = lambda x: np.asarray(x, np.float64)[:, :ncmp]
    return {
        "lw_up": get(s.lw_flux_up()), "lw_dn": get(s.lw_flux_dn()),
        "sw_up": get(s.sw_flux_up()), "sw_dn": get(s.sw_flux_dn()),
        "sw_dir": get(s.sw_direct_flux_dn()),
    }


def max_err(a: dict, b: dict, wave: str | None = None) -> float:
    keys = [k for k in a if wave is None or k.startswith(wave)]
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in keys)


def finite(f: dict) -> bool:
    return all(bool(np.all(np.isfinite(v))) for v in f.values())


class PhaseFailed(AssertionError):
    """A phase's check failed; ``measured`` holds what it measured so far."""

    def __init__(self, what: str, measured: dict):
        super().__init__(what)
        self.measured = measured


def check(cond: bool, what: str, measured: dict):
    if not cond:
        raise PhaseFailed(what, measured)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_gray(dev, ref, sz: Sizes) -> dict:
    P = rt.RRTMGPParameters()
    ncol = sz.gray_ncol
    lat = np.linspace(-90.0, 90.0, ncol)
    with jax.default_device(ref):
        atm = rt.setup_gray_as_pr_grid(
            sz.nlay, lat, 1e5, 9e3, rt.GrayOpticalThicknessSchneider2004(), P,
            dtype=jnp.float32,
        )
    emis = np.ones((ncol,), np.float32)
    fn = jax.jit(partial(rt.solve_gray_lw, params=P))
    args = on(dev, (atm, emis))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    out = {"ncol": ncol, "compile_s": time.perf_counter() - t0, "memory": memory(compiled)}
    up, dn, _ = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(sz.steps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    out["step_s_median"] = float(np.median(times))
    up, dn = np.asarray(up), np.asarray(dn)
    sfc = P.Stefan * np.asarray(atm.t_sfc, np.float64) ** 4
    out["toa_dn_max"] = float(np.max(np.abs(dn[-1])))
    out["sfc_up_rel_err"] = float(np.max(np.abs(up[0] - sfc) / sfc))
    up_c, dn_c, _ = fn(*on(ref, cols((atm, emis), ncol, 0, sz.ncmp)))
    out["err_vs_cpu_f32"] = max(
        float(np.max(np.abs(up[:, : sz.ncmp] - np.asarray(up_c)))),
        float(np.max(np.abs(dn[:, : sz.ncmp] - np.asarray(dn_c)))),
    )
    out["tol"] = TOL_ORDER_F32
    check(out["toa_dn_max"] == 0.0, "gray: TOA downward flux is not 0", out)
    check(out["sfc_up_rel_err"] <= 1e-5, "gray: surface upward flux != sigma T^4", out)
    check(out["err_vs_cpu_f32"] <= TOL_ORDER_F32, "gray: GPU differs from CPU", out)
    return out


def phase_clear(dev, ref, sz: Sizes) -> dict:
    """f32 clear pair at the largest of sz.clear_ncol that fits the device."""
    method = rt.ClearSkyRadiation()
    lk = lookups(sz, np.float32)
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    out = {"unfit": []}
    for ncol in sz.clear_ncol:
        atm, bl, bs = problem(sz, ncol, np.float32)
        s = solver(method, sz, dev, atm, bl, bs, lk, jnp.float32, two_stream_lw=False)
        comp = compile_update(s)
        need = comp["memory"].get("temp_size_in_bytes", 0)
        if not limit or need <= limit:
            break
        out["unfit"].append({"ncol": ncol, "temp_size_in_bytes": need, "bytes_limit": limit})
    out.update(ncol=ncol, **drive(s, sz.steps, comp), peak_bytes=peak_bytes(dev))
    got = fluxes(s, sz.ncmp)
    a = cols((atm, bl, bs), ncol, 0, sz.ncmp)
    r32 = solver(method, sz, ref, *a, lk, jnp.float32, two_stream_lw=False)
    r32.update_fluxes()
    r64 = solver(method, sz, ref, *cast(a, jnp.float64), cast(lk, jnp.float64),
                 jnp.float64, two_stream_lw=False)
    r64.update_fluxes()
    f32, f64 = fluxes(r32, sz.ncmp), fluxes(r64, sz.ncmp)
    for w in ("lw", "sw"):
        out[f"{w}_err_vs_cpu_f32"] = max_err(got, f32, w)
        out[f"{w}_err_vs_f64"] = max_err(got, f64, w)
        out[f"{w}_cpu_f32_err_vs_f64"] = max_err(f32, f64, w)
        out[f"{w}_envelope_f32"] = ENVELOPE_F32[w]
    out["tol"] = TOL_ORDER_F32
    check(finite(got), "clear: non-finite fluxes", out)
    for w in ("lw", "sw"):
        check(out[f"{w}_err_vs_cpu_f32"] <= TOL_ORDER_F32,
              f"clear {w}: GPU differs from CPU f32", out)
        check(out[f"{w}_err_vs_f64"] <= out[f"{w}_cpu_f32_err_vs_f64"] + TOL_ORDER_F32,
              f"clear {w}: GPU f32 error vs f64 exceeds the CPU's", out)
    return out


def phase_allsky(dev, ref, sz: Sizes, aero: bool = False) -> dict:
    """f32 McICA two-stream pair; the same solve on the CPU's first columns."""
    method = rt.AllSkyRadiation(aerosol_radiation=aero)
    ncol = sz.allsky_ncol
    lk = lookups(sz, np.float32, cloudy=True, aero=aero)
    atm, bl, bs = problem(sz, ncol, np.float32, cloudy=True, aero=aero)
    s = solver(method, sz, dev, atm, bl, bs, lk, jnp.float32)
    s.advance_step(11)
    out = {"ncol": ncol, **drive(s, sz.steps), "peak_bytes": peak_bytes(dev)}
    got = fluxes(s, sz.ncmp)
    r = solver(method, sz, ref, *cols((atm, bl, bs), ncol, 0, sz.ncmp), lk, jnp.float32)
    r.advance_step(11)
    r.update_fluxes()
    want = fluxes(r, sz.ncmp)
    out["err_vs_cpu_f32"] = max_err(got, want)
    out["tol"] = TOL_ORDER_F32
    cover = lambda x: np.asarray(x)[: sz.ncmp]
    out["cloud_cover_bitwise"] = bool(
        np.array_equal(cover(s.lw_cloud_cover()), cover(r.lw_cloud_cover()))
        and np.array_equal(cover(s.sw_cloud_cover()), cover(r.sw_cloud_cover()))
    )
    out["mean_cloud_cover"] = float(np.mean(np.asarray(s.lw_cloud_cover())))
    check(finite(got), "allsky: non-finite fluxes", out)
    check(out["cloud_cover_bitwise"], "allsky: McICA cloud cover differs from the CPU's", out)
    check(0.0 < out["mean_cloud_cover"] < 1.0, "allsky: McICA sampled no fractional cover", out)
    check(out["err_vs_cpu_f32"] <= TOL_ORDER_F32, "allsky: GPU differs from CPU f32", out)
    if aero:
        aod, aod_r = np.asarray(s.aod_sw_extinction()), np.asarray(r.aod_sw_extinction())
        out["aod_rel_err"] = float(
            np.max(np.abs(aod[: sz.ncmp] - aod_r)) / max(float(np.max(np.abs(aod_r))), 1e-30)
        )
        check(out["aod_rel_err"] <= 1e-5, "aerosky: AOD differs from the CPU's", out)
    return out


def phase_f64(dev, ref, sz: Sizes) -> dict:
    """Native f64 clear pair, unchunked and auto-chunked, vs the CPU in f64."""
    method = rt.ClearSkyRadiation()
    ncol = sz.f64_ncol
    lk = lookups(sz, np.float64)
    atm, bl, bs = problem(sz, ncol, np.float64)
    r = solver(method, sz, ref, *cols((atm, bl, bs), ncol, 0, sz.ncmp), lk, jnp.float64,
               two_stream_lw=False)
    r.update_fluxes()
    want = fluxes(r, sz.ncmp)
    scale = max(float(np.max(np.abs(v))) for v in want.values())
    out = {"ncol": ncol, "tol_rel": TOL_ORDER_F64_REL}
    for tag, budget in (("default", None), ("chunked", sz.f64_chunk_gb)):
        old = os.environ.pop("RRTMGP_CHUNK_BUDGET_GB", None)
        if budget is not None:
            os.environ["RRTMGP_CHUNK_BUDGET_GB"] = str(budget)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s = solver(method, sz, dev, atm, bl, bs, lk, jnp.float64, two_stream_lw=False)
        finally:
            os.environ.pop("RRTMGP_CHUNK_BUDGET_GB", None)
            if old is not None:
                os.environ["RRTMGP_CHUNK_BUDGET_GB"] = old
        res = {"auto_chunk": s.auto_chunk, **drive(s, sz.steps), "peak_bytes": peak_bytes(dev)}
        got = fluxes(s, sz.ncmp)
        res["rel_err_vs_cpu_f64"] = max_err(got, want) / scale
        out[tag] = res
        check(finite(got), f"f64 {tag}: non-finite fluxes", out)
        check(res["rel_err_vs_cpu_f64"] <= TOL_ORDER_F64_REL,
              f"f64 {tag}: GPU differs from CPU f64", out)
    check(out["chunked"]["auto_chunk"] is not None, "f64: the chunk budget did not chunk", out)
    return out


def phase_grad(dev, ref, sz: Sizes) -> dict:
    """jax.grad of the summed LW flux w.r.t. t_lay, f32, two-stream LW."""
    ncol = sz.grad_ncol
    lk = lookups(sz, np.float32).lookup_lw
    atm, bl, _ = problem(sz, ncol, np.float32)

    def total_lw(t_lay, atm, bcs, lk):
        flux, _ = rt.solve_lw(lk, dataclasses.replace(atm, t_lay=t_lay), bcs, two_stream=True)
        return jnp.sum(flux.flux_up + flux.flux_dn)

    g_fn = jax.jit(jax.grad(total_lw))
    args = on(dev, (atm.t_lay, atm, bl, lk))
    t0 = time.perf_counter()
    compiled = g_fn.lower(*args).compile()
    out = {"ncol": ncol, "compile_s": time.perf_counter() - t0, "memory": memory(compiled)}
    g = np.asarray(jax.block_until_ready(compiled(*args)), np.float64)
    out["peak_bytes"] = peak_bytes(dev)
    a = cols((atm.t_lay, atm, bl), ncol, 0, sz.ncmp)
    g32 = np.asarray(g_fn(*on(ref, (*a, lk))), np.float64)
    g64 = np.asarray(g_fn(*on(ref, cast((*a, lk), jnp.float64))), np.float64)
    scale = float(np.max(np.abs(g64)))
    rel = lambda x, y: float(np.max(np.abs(x - y))) / scale
    out["rel_err_vs_cpu_f32"] = rel(g[:, : sz.ncmp], g32)
    out["rel_err_vs_f64"] = rel(g[:, : sz.ncmp], g64)
    out["cpu_f32_rel_err_vs_f64"] = rel(g32, g64)
    out["tol_rel"] = TOL_GRAD_REL
    check(bool(np.all(np.isfinite(g))), "grad: non-finite gradient", out)
    check(out["rel_err_vs_cpu_f32"] <= TOL_GRAD_REL, "grad: GPU differs from CPU f32", out)
    check(out["rel_err_vs_f64"] <= out["cpu_f32_rel_err_vs_f64"] + TOL_GRAD_REL,
          "grad: GPU f32 error vs f64 exceeds the CPU's", out)
    return out


def phase_mesh(devs, sz: Sizes) -> dict:
    """All-sky pair on a column mesh over ``devs`` vs one-device solves of
    each shard's columns with the shard's global col_offset."""
    from rrtmgp_tpu.parallel.sharding import make_column_mesh, shard_columns

    n = len(devs)
    ncol = sz.mesh_ncol
    check(ncol % n == 0, f"mesh: {ncol} columns do not split over {n} devices", {})
    per = ncol // n
    method = rt.AllSkyRadiation()
    lk = lookups(sz, np.float32, cloudy=True)
    atm, bl, bs = problem(sz, ncol, np.float32, cloudy=True)
    mesh = make_column_mesh(devs)
    step = 5
    s = solver(method, sz, None, *(shard_columns(x, mesh, ncol) for x in (atm, bl, bs)),
               lk, jnp.float32, mesh=mesh)
    s.advance_step(step)
    out = {"ncol": ncol, "devices": n, **drive(s, sz.steps)}
    out["device_set"] = len(s.lw_flux_up().sharding.device_set)
    got = fluxes(s, ncol)
    cover = (np.asarray(s.lw_cloud_cover()), np.asarray(s.sw_cloud_cover()))

    @jax.jit
    def one(a, b_lw, b_sw, off):
        # the solver's McICA keys: 2*step + wave (RRTMGPSolver._mcica_key)
        flw, dlw = rt.solve_lw(lk.lookup_lw, a, b_lw, two_stream=True,
                               lkp_cld=lk.lookup_lw_cld, cld_mask_seed=jnp.int32(2 * step),
                               col_offset=off)
        fsw, dsw = rt.solve_sw(lk.lookup_sw, a, b_sw, lkp_cld=lk.lookup_sw_cld,
                               cld_mask_seed=jnp.int32(2 * step + 1), col_offset=off)
        return flw, fsw, dlw.cld_cover, dsw.cld_cover

    err, bitwise = 0.0, True
    for k in range(n):
        a, b_lw, b_sw = on(devs[0], cols((atm, bl, bs), ncol, k * per, (k + 1) * per))
        flw, fsw, clw, csw = one(a, b_lw, b_sw, jnp.int32(k * per))
        sl = slice(k * per, (k + 1) * per)
        want = {"lw_up": flw.flux_up, "lw_dn": flw.flux_dn, "sw_up": fsw.flux_up,
                "sw_dn": fsw.flux_dn, "sw_dir": fsw.flux_dn_dir}
        err = max(err, max(float(np.max(np.abs(got[key][:, sl] - np.asarray(v))))
                           for key, v in want.items()))
        bitwise &= bool(np.array_equal(cover[0][sl], np.asarray(clw))
                        and np.array_equal(cover[1][sl], np.asarray(csw)))
    out.update(err_vs_one_device=err, tol=TOL_ORDER_F32, cloud_cover_bitwise=bitwise,
               mean_cloud_cover=float(np.mean(cover[0])))
    check(out["device_set"] == n, "mesh: the output is not spread over every device", out)
    check(bitwise, "mesh: sharded McICA cloud cover differs from the per-shard solves", out)
    check(0.0 < out["mean_cloud_cover"] < 1.0, "mesh: McICA sampled no fractional cover", out)
    check(err <= TOL_ORDER_F32, "mesh: sharded fluxes differ from the per-shard solves", out)
    return out


PHASES = {
    "gray": phase_gray,
    "clear": phase_clear,
    "allsky": phase_allsky,
    "aerosky": partial(phase_allsky, aero=True),
    "f64": phase_f64,
    "grad": phase_grad,
}


def phases_for(argv) -> list[str]:
    """Phase names the command line selects: --four runs only the mesh."""
    return ["mesh"] if "--four" in argv else list(PHASES)


def run(names, devs, ref, sz: Sizes = FULL, gpu: str = "") -> bool:
    """Run the named phases; print one JSON line each; True iff all passed."""
    ok = True
    for name in names:
        t0 = time.perf_counter()
        try:
            res = phase_mesh(devs, sz) if name == "mesh" else PHASES[name](devs[0], ref, sz)
            res = {"phase": name, "ok": True, **res}
        except Exception as e:  # noqa: BLE001 — report every phase, then fail
            ok = False
            res = {"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}",
                   **getattr(e, "measured", {})}
            if not isinstance(e, PhaseFailed):
                res["trace"] = traceback.format_exc()[-1500:]
        res["wall_s"] = time.perf_counter() - t0
        res["gpu"] = gpu
        print(json.dumps(res, default=str), flush=True)
    return ok


def main(argv) -> int:
    t0 = time.perf_counter()
    try:
        info = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    names = phases_for(argv)
    want = 4 if "--four" in argv else 1
    if info["count"] < want:
        print(f"chip_smoke.py: needs {want} GPUs, JAX sees {info['count']}", file=sys.stderr)
        return 2
    gpu = gpu_name_and_power_limit()
    enable_compile_cache()
    print(json.dumps({"phase": "device", "ok": True, **info, "jax": jax.__version__,
                      "nvidia_smi": gpu.splitlines()}), flush=True)
    print(gpu, flush=True)  # name, power.limit — as nvidia-smi gives them
    devs = jax.devices()[:want]
    if not run(names, devs, jax.devices("cpu")[0], FULL, gpu.splitlines()[0]):
        return 1
    print(json.dumps({"total_wall_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ok": True, "device": {**info, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
