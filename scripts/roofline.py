"""Roofline inputs of record for the flagship configurations.

XLA cost analysis (flops / transcendentals / bytes accessed) of the
compiled flagship step on the attached backend, per (dtype, diags)
configuration, normalized per (level, column) cell.  Combined with a
measured columns/s these give the sustained arithmetic rate and the
memory-traffic rate.

Caveat recorded with the output: XLA cost analysis counts each
while_loop BODY ONCE, so the pH solver's per-iteration cost is not
multiplied by its trip count — the flops figures are per-trace, not
per-execution (scripts/ph_iter_stats.py measures the dynamic part).

Usage (from the repository root): PYTHONPATH=. python scripts/roofline.py
Knobs: OBGC_ROOF_PLATFORM=cpu, OBGC_ROOF_NCOL, OBGC_ROOF_NLEV
"""

import json
import os
import sys

import jax

if os.environ.get("OBGC_ROOF_PLATFORM", "") == "cpu":
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.ops.bgc import precompute_env
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.profiling import cost_summary
from ocean_bgc.utils.synthetic import synthetic_world


def main():
    nlev = int(os.environ.get("OBGC_ROOF_NLEV", "60"))
    ncol = int(os.environ.get("OBGC_ROOF_NCOL", "8192"))
    params = ModelParams()
    cells = nlev * ncol
    out = {"nlev": nlev, "ncol": ncol,
           "platform": jax.devices()[0].platform,
           "note": ("while_loop bodies counted once by XLA cost "
                    "analysis; dynamic solver iterations not included")}

    for name, dtype, diags in (("f64_diags_off", None, False),
                               ("f64_diags_on", None, True),
                               ("f32_diags_off", jnp.float32, False)):
        state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol,
                                               dtype=dtype)
        env = precompute_env(grid, forcing, params.bgc)

        def fn(s):
            return step(s, grid, forcing, params, 3600.0,
                        compute_diags=diags, env=env)

        c = cost_summary(fn, state)
        out[name] = {
            "flops_per_cell": round(c["flops"] / cells, 1),
            "transcendentals_per_cell": round(
                c["transcendentals"] / cells, 2),
            "bytes_per_cell": round(c["bytes accessed"] / cells, 1),
            "flops_total": c["flops"],
            "bytes_total": c["bytes accessed"],
        }
        print(json.dumps({name: out[name]}), flush=True)

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
