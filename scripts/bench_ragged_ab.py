"""Ragged-world solver A/B.

The default bench world is flat-bottom (ragged=False, every lane
active), so the inactive-lane stand-in seed (EnvCache.standin_ph)
never fires there.  Real oceans are ragged (land + shelves), and the
batched solver pays the MAX lane iteration count — this script measures
the flagship-shaped RAGGED world (15% shelf columns, 2% land; the
synthetic_world default) in three solver configurations on the attached
backend:

  a. no_standin_seed  — round-4 behavior (inactive lanes solve cold
                        every step; ~13 trips)
  b. default          — stand-in seed + trusted bracket skip (round-5
                        default; ~3 trips, bitwise)
  c. x0_seed          — plus OBGC_X0_SEED (opt-in; ~1 trip, root equal
                        to solver tolerance)

One JSON line per config: columns/s per device, scalar-readback
timing, best of BENCH_REPEATS.  Note config (c) requires this script to be
launched with OBGC_X0_SEED=1; it is skipped otherwise (the flag is
read at trace time by ops/bgc.py).

Usage (from the repository root):
  [OBGC_X0_SEED=1] PYTHONPATH=. python scripts/bench_ragged_ab.py
Knobs: BENCH_NCOL (8192), BENCH_NLEV (60), BENCH_STEPS (10),
       BENCH_REPEATS (3), BENCH_PLATFORM=cpu
"""

import json
import os
import sys
import time

import jax

if os.environ.get("BENCH_PLATFORM", "") == "cpu":
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.ops.bgc import precompute_env
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


PROD_FILTER = ("pco2surf", "dpco2", "NITRIF", "DENITRIF",
               "POC_FLUX_IN", "photoC_TOT_zint", "tot_CaCO3_form_zint",
               "Jint_Ctot", "O2_ZMIN", "Chl_TOT_zint_100m")


def measure(state, grid, forcing, params, env, nsteps, repeats,
            diag_filter=None):
    diags = diag_filter is not None

    def one(s):
        s2, d = step(s, grid, forcing, params, 3600.0,
                     compute_diags=diags, env=env,
                     diag_filter=diag_filter)
        return (s2, d) if diags else s2

    stepj = jax.jit(one, donate_argnums=0)
    if diags:
        inner = stepj
        stepj = lambda s: inner(s)[0]  # noqa: E731  (history discarded)
    # the caller reuses `state` across configs; donation consumes it
    s = jax.tree.map(jnp.copy, state)
    s = stepj(s)                          # compile + first (cold) step
    s = stepj(s)                          # warm all lanes
    float(jnp.sum(s.bgc.tracers))         # sync (scalar readback)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(nsteps):
            s = stepj(s)
        float(jnp.sum(s.bgc.tracers))
        best = min(best, (time.perf_counter() - t0) / nsteps)
    return best


def main():
    ncol = int(os.environ.get("BENCH_NCOL", "8192"))
    nlev = int(os.environ.get("BENCH_NLEV", "60"))
    nsteps = int(os.environ.get("BENCH_STEPS", "10"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    params = ModelParams()

    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol,
                                           seed=17, ragged=True)
    env = precompute_env(grid, forcing, params.bgc)
    active_frac = float(jnp.mean(
        grid.active_mask().astype(jnp.float64)))

    x0_on = os.environ.get("OBGC_X0_SEED", "0") == "1"
    suffix = "_x0" if x0_on else ""
    if os.environ.get("BENCH_RAGGED_DIAGS", "0") == "1":
        # the production-history configuration: ragged bathymetry +
        # the 10-field selective history (diag_filter)
        configs = [(f"ragged_prod_history10{suffix}", env, PROD_FILTER)]
    elif x0_on:
        # the x0 run measures only its own config (the no-seed A leg
        # belongs to the flag-off run)
        configs = [("ragged_default_x0", env, None)]
    else:
        configs = [("ragged_no_standin_seed",
                    env._replace(standin_ph=None), None),
                   ("ragged_default", env, None)]
    out = {"ncol": ncol, "nlev": nlev,
           "platform": jax.devices()[0].platform,
           "active_lane_frac": round(active_frac, 4),
           "x0_seed": x0_on}
    for name, e, filt in configs:
        t = measure(state, grid, forcing, params, e, nsteps, repeats,
                    diag_filter=filt)
        out[name] = round(ncol / t, 1)
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
