"""Standalone model runner (`python -m ocean_bgc.run_model`).

The reference is a library with no driver; this is the production driver a
deployment would use: config from TOML, synthetic or checkpointed initial
state, jitted stepping (optionally sharded over every visible device),
periodic checkpoints and time-averaged history output, and an end-of-run
summary with throughput and conservation residuals.

Examples::

    python -m ocean_bgc.run_model --steps 240 --ncol 4096
    python -m ocean_bgc.run_model --config run.toml --steps 480 \
        --restore ck_0240 --checkpoint-every 240 --out /tmp/run1
    python -m ocean_bgc.run_model --steps 96 --sharded \
        --history-every 24 --integrator rk2
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocean_bgc.run_model",
        description="Run the coupled BGC+DMS+MACROS column model.")
    p.add_argument("--config", help="TOML parameter overrides")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--dt", type=float, default=3600.0,
                   help="timestep (s), default 1 h")
    p.add_argument("--nlev", type=int, default=60)
    p.add_argument("--ncol", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--integrator", choices=("euler", "rk2", "rk4"),
                   default="euler")
    p.add_argument("--sharded", action="store_true",
                   help="shard columns over all visible devices")
    p.add_argument("--restore", help="checkpoint path to resume from")
    p.add_argument("--out", default=".",
                   help="output directory for checkpoints/history")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints (0 = only final)")
    p.add_argument("--history-every", type=int, default=0,
                   help="steps between history writes (0 = none)")
    p.add_argument("--history-fields",
                   help="comma-separated diagnostic names to emit "
                        "(default: all ~150; unlisted fields are "
                        "dead-code-eliminated from the compiled step — "
                        "the selective-diagnostics production "
                        "configuration)")
    p.add_argument("--fp32", action="store_true",
                   help="opt-in single-precision fast path")
    p.add_argument("--world",
                   help="NetCDF world file (io.model_io.save_world "
                        "layout) supplying grid/forcing/initial state "
                        "instead of the synthetic generator")
    p.add_argument("--save-world",
                   help="write the final grid/forcing/state as a "
                        "NetCDF world file")
    p.add_argument("--forcing-series",
                   help="NetCDF forcing series (leading time axis; see "
                        "models/forcing_series.save_forcing_series) — "
                        "interpolated per step instead of held forcing")
    p.add_argument("--interp", choices=("linear", "hold"),
                   default="linear",
                   help="forcing-series interpolation mode")
    p.add_argument("--no-env-cache", action="store_true",
                   help="recompute the coefficient tables every step "
                        "(the reference's semantics) instead of "
                        "amortizing them per forcing snapshot/record")
    p.add_argument("--health", action="store_true",
                   help="accumulate pH-solver non-convergence and "
                        "poc_error counters into the summary")
    p.add_argument("--solver-seed", action="store_true",
                   help="opt into the previous-root pH-solver seed "
                        "(OBGC_X0_SEED=1): ~1 warm iteration instead "
                        "of 2-3; root equal to solver tolerance but not "
                        "the reference iterate sequence (qualified, "
                        "tests/test_x0_seed_trajectory.py)")
    p.add_argument("--netcdf-history", action="store_true",
                   help="write history as NetCDF instead of npz")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if args.solver_seed:
        # must land before the first trace (the flag is read at trace
        # time, ops/carbonate.py::x0_seed_enabled)
        os.environ["OBGC_X0_SEED"] = "1"

    import jax
    import jax.numpy as jnp
    import numpy as np

    import ocean_bgc  # noqa: F401
    from ocean_bgc.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ocean_bgc.models import integrators
    from ocean_bgc.models.coupled import step
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils import checkpoint as ckpt
    from ocean_bgc.utils.history import TavgState, write_history
    from ocean_bgc.utils.synthetic import synthetic_world

    params = ModelParams()
    if args.config:
        from ocean_bgc.utils.config import params_from_toml
        params = params_from_toml(args.config)

    dtype = jnp.float32 if args.fp32 else None
    if args.world:
        from ocean_bgc.io.model_io import load_world
        state, grid, forcing = load_world(args.world, dtype=dtype)
        if not args.quiet:
            print(f"world <- {args.world} "
                  f"({state.bgc.nlev} levels x {state.bgc.ncol} columns)")
    else:
        state, grid, forcing = synthetic_world(
            nlev=args.nlev, ncol=args.ncol, seed=args.seed, dtype=dtype)

    start_step = 0
    if args.restore:
        state, n = ckpt.restore(args.restore)
        start_step = n or 0
        if not args.quiet:
            print(f"resumed from {args.restore} at step {start_step}")

    step_impl = {"euler": step, "rk2": integrators.step_rk2,
                 "rk4": integrators.step_rk4}[args.integrator]

    if args.sharded:
        from ocean_bgc.parallel import make_mesh, shard_world
        mesh = make_mesh()
        state, grid, forcing = shard_world(state, grid, forcing, mesh)
        if not args.quiet:
            print(f"sharded over {mesh.devices.size} device(s)")

    want_diags = args.history_every > 0

    series = record_dt = None
    if args.forcing_series:
        from ocean_bgc.models.forcing_series import (
            forcing_at, forcing_record, load_forcing_series)
        series, record_dt = load_forcing_series(args.forcing_series,
                                                dtype=dtype)
        if not args.quiet:
            nrec = jax.tree.leaves(series)[0].shape[0]
            print(f"forcing series <- {args.forcing_series} "
                  f"({nrec} records, {record_dt:.0f} s apart, "
                  f"{args.interp})")

    # env cache: constant forcing -> build once; series + hold ->
    # rebuild at record boundaries (host loop, exact); series +
    # linear -> exact per-step recompute (env_mode='interp' exists on
    # run_forced for the qualified approximation)
    use_env = not args.no_env_cache
    from ocean_bgc.ops.bgc import precompute_env
    # jitted: run eagerly, each of its operations would compile on its own
    precompute_env = jax.jit(precompute_env, static_argnums=2)

    dfilter = (tuple(x for x in args.history_fields.split(",") if x)
               if args.history_fields else None)
    if dfilter and not want_diags:
        raise SystemExit("--history-fields requires --history-every N "
                         "(without history output there are no "
                         "diagnostics to select)")

    # grid and forcing are arguments, not closed-over constants, so the
    # compiled program does not embed the world
    @jax.jit
    def advance(s, g, f, env):
        return step_impl(s, g, f, params, args.dt,
                         compute_diags=want_diags, env=env,
                         health=args.health, diag_filter=dfilter)

    os.makedirs(args.out, exist_ok=True)
    tavg = None
    env = (precompute_env(grid, forcing, params.bgc)
           if use_env and series is None else None)
    cur_rec = None
    forcing_now = forcing
    health_tot = {"health_solver_nonconverged_cells": 0.0,
                  "health_poc_error_cells": 0.0}
    t0 = time.perf_counter()
    for i in range(start_step, start_step + args.steps):
        if series is not None:
            t = (i + 0.5) * args.dt / record_dt
            if args.interp == "hold":
                nrec = jax.tree.leaves(series)[0].shape[0]
                rec = int(np.clip(np.floor(t), 0, nrec - 1))
                forcing_now = forcing_record(series, rec)
                if use_env and rec != cur_rec:
                    env = precompute_env(grid, forcing_now, params.bgc)
                    cur_rec = rec
            else:
                forcing_now = forcing_at(series, t)
                env = None
        state, diags = advance(state, grid, forcing_now, env)
        if args.health:
            for k in health_tot:
                health_tot[k] += float(diags[k])
        if want_diags:
            if tavg is None:
                tavg = TavgState.create(diags)
            tavg = tavg.accumulate(diags)
            if (i + 1) % args.history_every == 0:
                if args.netcdf_history:
                    from ocean_bgc.io.model_io import (
                        save_history_netcdf)
                    path = save_history_netcdf(
                        os.path.join(args.out, f"hist_{i + 1:06d}.nc"),
                        {k: np.asarray(v)
                         for k, v in tavg.means().items()},
                        nlev=state.bgc.nlev, ncol=state.bgc.ncol,
                        count=int(tavg.count),
                        attrs={"dt": args.dt, "step": np.int32(i + 1)})
                else:
                    path = write_history(
                        os.path.join(args.out, f"hist_{i + 1:06d}"), tavg,
                        attrs={"dt": str(args.dt), "step": str(i + 1)})
                tavg = tavg.reset()
                if not args.quiet:
                    print(f"history -> {path}")
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            path = ckpt.save(os.path.join(args.out, f"ck_{i + 1:06d}"),
                             state, step=i + 1)
            if not args.quiet:
                print(f"checkpoint -> {path}")
    jax.block_until_ready(state.bgc.tracers)
    elapsed = time.perf_counter() - t0

    final_ck = ckpt.save(os.path.join(args.out, "ck_final"), state,
                         step=start_step + args.steps)
    if args.save_world:
        from ocean_bgc.io.model_io import save_world
        save_world(args.save_world, jax.device_get(state),
                   jax.device_get(grid), jax.device_get(forcing),
                   attrs={"step": np.int32(start_step + args.steps)})
        if not args.quiet:
            print(f"world -> {args.save_world}")
    # the summary needs only the conservation residual — filter so the
    # extra evaluation doesn't pay for all ~155 diagnostics
    _, final_diags = jax.jit(
        lambda s, g, f: step(s, g, f, params, args.dt, compute_diags=True,
                             diag_filter=("Jint_Ctot",)))(
        state, grid, forcing_now)
    jint = float(np.abs(np.asarray(final_diags["Jint_Ctot"])).max())
    summary = {
        "steps": args.steps,
        "columns": args.ncol,
        "columns_per_s": round(args.ncol * args.steps / elapsed, 1),
        "elapsed_s": round(elapsed, 2),
        "final_checkpoint": final_ck,
        "max_abs_Jint_Ctot": jint,
        "finite": bool(np.isfinite(np.asarray(state.bgc.tracers)).all()),
    }
    if args.health:
        summary.update({f"{k}_total": v for k, v in health_tot.items()})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
