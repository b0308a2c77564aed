"""Subprocess worker for the real multi-process distributed test.

Invoked as ``python tests/mp_worker_distributed.py <pid> <nproc> <port>
<outdir> <devices_per_proc>``.  Each process owns ``devices_per_proc``
virtual CPU devices; together they form the global columns mesh — the
actual multi-host code path of ``ocean_bgc.parallel.distributed``
(SURVEY.md §4/§5), not the single-process virtual mesh.

Each process:
1. ``distributed.initialize`` against the shared coordinator,
2. builds the full deterministic synthetic world, keeps only its
   host-local column block, and assembles the global sharded pytrees via
   ``host_local_to_global``,
3. runs the shard_map'd coupled step (``make_sharded_step``) with the
   psum'd global diagnostics — a REAL cross-process collective,
4. writes a SHARDED orbax checkpoint of the stepped state (each process
   contributes only its addressable shards), restores it onto the same
   global mesh, asserts the restored local shards are bitwise identical,
   and continues one more step from the RESTORED state — the pod
   restart contract (pH warm-start fields, BGC_parms.F90:151-152,171),
5. writes its addressable output shards (2-step and restored+1-step) +
   the replicated global sums to ``<outdir>/proc<pid>.npz`` for the
   parent test to reassemble.
"""

import os
import sys


def main():
    pid, nproc, port, outdir, dpp = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        int(sys.argv[5]))
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dpp}")

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    import ocean_bgc  # noqa: F401  (enables x64)
    from ocean_bgc.parallel import distributed as dist
    from ocean_bgc.parallel import make_sharded_step
    from ocean_bgc.parallel.sharding import GLOBAL_SUM_DIAGS
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.synthetic import synthetic_world

    dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()

    mesh = dist.global_mesh()
    total_cols = 32
    state, grid, forcing = synthetic_world(nlev=6, ncol=total_cols,
                                           seed=29, ragged=True)

    lo, hi = dist.host_local_columns(total_cols, mesh)

    def local_block(tree):
        return jax.tree.map(lambda x: np.asarray(x)[..., lo:hi], tree)

    gstate = dist.host_local_to_global(local_block(state), mesh,
                                       total_cols)
    ggrid = dist.host_local_to_global(local_block(grid), mesh, total_cols)
    gforcing = dist.host_local_to_global(local_block(forcing), mesh,
                                         total_cols)

    fn = make_sharded_step(mesh, ModelParams(), 3600.0,
                           compute_diags=True, nsteps=2)
    final, gdiags = fn(gstate, ggrid, gforcing)
    jax.block_until_ready(final)

    # ---- sharded checkpoint round-trip (multi-host restart contract) ----
    from ocean_bgc.utils import checkpoint as ckpt
    ckpt_path = os.path.join(outdir, "ckpt_sharded")
    ckpt.save(ckpt_path, final, step=2, use_orbax=True)
    restored, rstep = ckpt.restore(ckpt_path, mesh=mesh)
    assert rstep == 2, rstep

    def local_shards(arr):
        return {(s.index[-1].start or 0): np.asarray(s.data)
                for s in arr.addressable_shards}

    # restored local shards must be bitwise identical to what this
    # process computed (no gather, no precision loss)
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(restored)):
        la, lb = local_shards(a), local_shards(b)
        assert la.keys() == lb.keys()
        for k in la:
            assert np.array_equal(la[k], lb[k],), "restore not bitwise"

    # continue ONE more step from the RESTORED state: bitwise resume
    fn1 = make_sharded_step(mesh, ModelParams(), 3600.0,
                            compute_diags=False, nsteps=1)
    cont, _ = fn1(restored, ggrid, gforcing)

    # ---- pod history: sharded local_diags -> per-process shard files
    # (the consumer of make_sharded_step(local_diags=...); VERDICT r4
    # item 3) -- includes a psum'd health counter to exercise the
    # replicated-leaf path ----
    from ocean_bgc.utils.history import write_history_shards

    LOCAL_DIAGS = ("NITRIF", "pco2surf", "POC_FLUX_IN",
                   "health_poc_error_cells")
    fnh = make_sharded_step(mesh, ModelParams(), 3600.0,
                            compute_diags=True, nsteps=1, health=True,
                            local_diags=LOCAL_DIAGS)
    _, _, hlocal = fnh(gstate, ggrid, gforcing)
    write_history_shards(os.path.join(outdir, "history"), hlocal)

    # ---- production rehearsal E2E (VERDICT r4 item 6): restore ->
    # sharded forced run (hold interp, per-record env cache) ->
    # selective history + health psums -> checkpoint again -> bitwise
    # continuation.  The composition a real deployment runs. ----
    from ocean_bgc.parallel.sharding import make_sharded_forced_run
    from ocean_bgc.models.forcing_series import stack_forcings
    import dataclasses as _dc

    forcing2 = _dc.replace(
        forcing,
        sst=forcing.sst + 0.5,
        potential_temperature=forcing.potential_temperature + 0.5,
        shortwave_surface=forcing.shortwave_surface * 1.1)
    series = stack_forcings([forcing, forcing2])
    gseries = dist.host_local_to_global(local_block(series), mesh,
                                        total_cols)
    ffn = make_sharded_forced_run(mesh, ModelParams(), 3600.0, 4,
                                  2 * 3600.0, interp="hold",
                                  env_mode="hold")
    prod = ffn(restored, ggrid, gseries)
    prod2, _, plocal = fnh(prod, ggrid, gforcing)
    write_history_shards(os.path.join(outdir, "history2"), plocal)

    ckpt2_path = os.path.join(outdir, "ckpt2_sharded")
    ckpt.save(ckpt2_path, prod2, step=8, use_orbax=True)
    restored2, r2step = ckpt.restore(ckpt2_path, mesh=mesh)
    assert r2step == 8, r2step
    cont_direct, _ = fn1(prod2, ggrid, gforcing)
    cont_restored, _ = fn1(restored2, ggrid, gforcing)
    for a, b in zip(jax.tree.leaves(cont_direct),
                    jax.tree.leaves(cont_restored)):
        la, lb = local_shards(a), local_shards(b)
        assert la.keys() == lb.keys()
        for k in la:
            assert np.array_equal(la[k], lb[k]), (
                "rehearsal continuation not bitwise after restore")

    # collect this process's addressable output shards
    out = {}
    for tag, arr in (("tracers", final.bgc.tracers),
                     ("cont", cont.bgc.tracers),
                     ("prod", prod2.bgc.tracers)):
        for shard in arr.addressable_shards:
            col0 = shard.index[-1].start or 0
            out[f"{tag}_{col0}"] = np.asarray(shard.data)
    for name in GLOBAL_SUM_DIAGS:
        out[f"gsum_{name}"] = np.asarray(gdiags[name])
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), **out)
    print(f"proc {pid}: ok devices={len(jax.devices())} "
          f"local=[{lo},{hi})", flush=True)


if __name__ == "__main__":
    main()
