"""Measure the pH-solver iteration distribution on the flagship state.

The production interior solve batches ALL (nlev x ncol) cells into one
masked ``lax.while_loop`` (ops/bgc.py): each lane freezes when converged,
but the loop runs until the LAST lane converges — so the step pays the
per-iteration cost (a full 12-term TA residual over the whole batch,
co2calc.F90:1001-1092) times the MAX iteration count, not the mean.
This script publishes that distribution (the reference documents ~12
cold / ~5 warm iterations, co2calc.F90:858-863).

Cases measured, after OBGC_STATS_WARMUP steps of the coupled model
(warm regime):

  interior_ambient / interior_alt   the two interior scenario solves,
                                    exactly as bgc_source_sink forms
                                    them (env-cache coeffs, stand-in
                                    values in inactive cells, H-space
                                    warm brackets)
  interior_cold                     same cells, all lanes cold (the
                                    wide [6,9] bracket) — step-0 cost
  surface_pair                      the stacked surface dual solve

Stats per case: mean/p50/p90/p99/max iterations, split active vs
inactive lanes, plus converged fraction.  One JSON line to stdout.

Usage (from the repository root): PYTHONPATH=. python scripts/ph_iter_stats.py
Knobs: OBGC_STATS_PLATFORM=cpu, OBGC_STATS_NCOL, OBGC_STATS_NLEV,
       OBGC_STATS_WARMUP
"""

import json
import os
import sys

import numpy as np

import jax

if os.environ.get("OBGC_STATS_PLATFORM", "") == "cpu":
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from ocean_bgc import constants as c
from ocean_bgc.models.coupled import step
from ocean_bgc.ops.bgc import precompute_env
from ocean_bgc.ops.carbonate import (
    _to_mass_units,
    carbonate_coeffs,
    solve_htotal_stats,
    warm_brackets_h,
)
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def pct(x, q):
    return float(np.percentile(x, q))


def lane_stats(iters, conv, mask=None):
    it = np.asarray(iters)
    cv = np.asarray(conv)
    if mask is not None:
        it = it[mask]
        cv = cv[mask]
    if it.size == 0:
        return None
    return {
        "lanes": int(it.size),
        "mean": round(float(it.mean()), 3),
        "p50": pct(it, 50),
        "p90": pct(it, 90),
        "p99": pct(it, 99),
        "max": int(it.max()),
        "converged_frac": round(float(cv.mean()), 6),
    }


def main():
    nlev = int(os.environ.get("OBGC_STATS_NLEV", "60"))
    ncol = int(os.environ.get("OBGC_STATS_NCOL", "2048"))
    warmup = int(os.environ.get("OBGC_STATS_WARMUP", "5"))
    dt = 3600.0

    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol)
    params = ModelParams()
    env = precompute_env(grid, forcing, params.bgc)

    stepj = jax.jit(lambda s: step(s, grid, forcing, params, dt,
                                   compute_diags=False, env=env)[0])
    for _ in range(warmup):
        state = stepj(state)
    jax.block_until_ready(state)

    # --- rebuild the interior solver inputs exactly as bgc_source_sink
    # does (ops/bgc.py:1094-1199) ---
    trc = jnp.maximum(state.bgc.tracers, 0.0)
    active = grid.active_mask()
    temp = forcing.potential_temperature
    salt = forcing.salinity
    from ocean_bgc.state import BGCTracers as T
    dic = trc[:, T.DIC]
    alk = trc[:, T.ALK]
    po4 = trc[:, T.PO4]
    sio3 = trc[:, T.SIO3]
    dic_s = jnp.where(active, dic, 2000.0)
    alk_s = jnp.where(active, alk, 2300.0)
    temp_s = jnp.where(active, temp, 10.0)
    salt_s = jnp.where(active, salt, 35.0)
    depth_m = grid.cell_center_depth * 0.01
    k_index = jnp.arange(nlev)
    subsurface = (k_index > 0)[:, None]

    coeffs = env.coeffs
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(dic_s, alk_s, po4, sio3)

    @jax.jit
    def run_stats(ph_prev, ph_prev_alt):
        br = warm_brackets_h(ph_prev, c.PHLO_3D_INIT, c.PHHI_3D_INIT,
                             c.DEL_PH)
        br_alt = warm_brackets_h(ph_prev_alt, c.PHLO_3D_INIT,
                                 c.PHHI_3D_INIT, c.DEL_PH)
        out = {}
        for name, (x1, x2) in (("interior_ambient", br),
                               ("interior_alt", br_alt)):
            _, iters, conv = solve_htotal_stats(
                coeffs, dic_m, ta_m, pt_m, sit_m, x1, x2)
            out[name] = (iters, conv)
        # all-cold: the sentinel wide bracket
        zero = jnp.zeros_like(ph_prev)
        brc = warm_brackets_h(zero, c.PHLO_3D_INIT, c.PHHI_3D_INIT,
                              c.DEL_PH)
        _, iters, conv = solve_htotal_stats(
            coeffs, dic_m, ta_m, pt_m, sit_m, brc[0], brc[1])
        out["interior_cold"] = (iters, conv)
        # round-5 production path: inactive lanes seeded from the
        # cached stand-in root (EnvCache.standin_ph)
        if env.standin_ph is not None:
            seeded = jnp.where(active, ph_prev, env.standin_ph)
            brs = warm_brackets_h(seeded, c.PHLO_3D_INIT,
                                  c.PHHI_3D_INIT, c.DEL_PH)
            _, iters, conv = solve_htotal_stats(
                coeffs, dic_m, ta_m, pt_m, sit_m, brs[0], brs[1])
            out["interior_ambient_standin_seeded"] = (iters, conv)
        return out

    res = run_stats(state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d)
    res = jax.tree.map(np.asarray, res)
    act = np.asarray(active)

    report = {
        "nlev": nlev, "ncol": ncol, "warmup_steps": warmup,
        "platform": jax.devices()[0].platform,
        "active_lane_frac": round(float(act.mean()), 4),
    }
    for name, (iters, conv) in res.items():
        report[name] = {
            "all": lane_stats(iters, conv),
            "active": lane_stats(iters, conv, act),
            "inactive": lane_stats(iters, conv, ~act),
        }

    # --- surface stacked dual solve, as ops/surface.py forms it ---
    scoef = carbonate_coeffs(forcing.surface_depth, forcing.sst,
                             forcing.sss, False, k1_k2_ph_tot=True)
    sd_a, sta, spt, ssit = _to_mass_units(
        trc[0, T.DIC], trc[0, T.ALK], trc[0, T.PO4], trc[0, T.SIO3])
    sd_b, _, _, _ = _to_mass_units(
        trc[0, T.DIC_ALT_CO2], trc[0, T.ALK], trc[0, T.PO4],
        trc[0, T.SIO3])
    sbr_a = warm_brackets_h(state.bgc.surface_ph, c.PHLO_SURF_INIT,
                            c.PHHI_SURF_INIT, c.DEL_PH)
    sbr_b = warm_brackets_h(state.bgc.surface_ph_alt, c.PHLO_SURF_INIT,
                            c.PHHI_SURF_INIT, c.DEL_PH)

    @jax.jit
    def run_surface():
        dic2 = jnp.stack([sd_a, sd_b])
        x1 = jnp.stack([sbr_a[0], sbr_b[0]])
        x2 = jnp.stack([sbr_a[1], sbr_b[1]])
        return solve_htotal_stats(scoef, dic2, sta, spt, ssit, x1, x2)

    _, s_iters, s_conv = jax.tree.map(np.asarray, run_surface())
    has_ocean = np.asarray(grid.kmax > 0)
    smask = np.broadcast_to(has_ocean, s_iters.shape)
    report["surface_pair"] = {
        "all": lane_stats(s_iters, s_conv),
        "ocean": lane_stats(s_iters, s_conv, smask),
        "land": lane_stats(s_iters, s_conv, ~smask),
    }

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
