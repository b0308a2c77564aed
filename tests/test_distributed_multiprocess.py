"""REAL multi-process distributed execution (the reference host model's
MPI analogue, SURVEY.md §4/§5): two OS processes, each owning two virtual
CPU devices, form one 4-device columns mesh via ``jax.distributed`` and
run the shard_map'd coupled step with a genuine cross-process psum (Gloo
collectives).  The reassembled result must match a plain single-process
run of the identical world — proving the multi-host code path in
``parallel/distributed.py`` (initialize / global_mesh /
host_local_columns / host_local_to_global) end to end, not just the
single-process virtual mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np

import ocean_bgc  # noqa: F401
from ocean_bgc.models.coupled import step
from ocean_bgc.parallel.sharding import GLOBAL_SUM_DIAGS
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world

NPROC = 2
DEVICES_PER_PROC = 2
TOTAL_COLS = 32


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single_process(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "mp_worker_distributed.py")
    port = _free_port()

    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # the worker sets its own XLA_FLAGS / platform before first jax use
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(NPROC), str(port),
             str(tmp_path), str(DEVICES_PER_PROC)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(NPROC)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"

    # ---- reassemble the distributed result ----
    nlev, ntrc = 6, 30
    got = np.full((nlev, ntrc, TOTAL_COLS), np.nan)
    got_cont = np.full((nlev, ntrc, TOTAL_COLS), np.nan)
    got_prod = np.full((nlev, ntrc, TOTAL_COLS), np.nan)
    gsums = {}
    for pid in range(NPROC):
        with np.load(tmp_path / f"proc{pid}.npz") as f:
            for key in f.files:
                if key.startswith("tracers_"):
                    col0 = int(key.split("_")[1])
                    block = f[key]
                    got[:, :, col0:col0 + block.shape[-1]] = block
                elif key.startswith("cont_"):
                    col0 = int(key.split("_")[1])
                    block = f[key]
                    got_cont[:, :, col0:col0 + block.shape[-1]] = block
                elif key.startswith("prod_"):
                    col0 = int(key.split("_")[1])
                    block = f[key]
                    got_prod[:, :, col0:col0 + block.shape[-1]] = block
                elif key.startswith("gsum_"):
                    gsums.setdefault(key[5:], []).append(float(f[key]))
    assert not np.isnan(got).any(), "missing output shards"
    assert not np.isnan(got_cont).any(), "missing restored-continue shards"
    assert not np.isnan(got_prod).any(), "missing rehearsal shards"
    # the replicated global sums must agree across processes exactly
    for name, vals in gsums.items():
        assert len(vals) == NPROC
        assert vals[0] == vals[1], name

    # ---- single-process reference of the identical configuration ----
    state, grid, forcing = synthetic_world(nlev=6, ncol=TOTAL_COLS,
                                           seed=29, ragged=True)
    params = ModelParams()
    s1, _ = step(state, grid, forcing, params, 3600.0,
                 compute_diags=False)
    s2, diags = step(s1, grid, forcing, params, 3600.0,
                     compute_diags=True)

    np.testing.assert_allclose(got, np.asarray(s2.bgc.tracers),
                               rtol=1e-12, atol=1e-18)
    # the restored-checkpoint continuation must equal a third plain step
    # of the same world — proving the sharded orbax save/restore carries
    # the full restart payload (tracers + pH warm-start fields) bitwise
    s3, _ = step(s2, grid, forcing, params, 3600.0, compute_diags=False)
    np.testing.assert_allclose(got_cont, np.asarray(s3.bgc.tracers),
                               rtol=1e-12, atol=1e-18)
    for name in GLOBAL_SUM_DIAGS:
        want = float(np.sum(np.asarray(diags[name])))
        # cross-shard psum associates differently than one global sum
        np.testing.assert_allclose(gsums[name][0], want, rtol=1e-11,
                                   atol=1e-14, err_msg=name)

    # ---- pod history: stitch the per-process shard files and compare
    # against a single-process evaluation of the same selective
    # history (VERDICT r4 item 3) ----
    from ocean_bgc.utils.history import stitch_history_shards

    hist = stitch_history_shards(str(tmp_path / "history"))
    _, hdiags = step(state, grid, forcing, params, 3600.0,
                     compute_diags=True, health=True,
                     diag_filter=("NITRIF", "pco2surf", "POC_FLUX_IN"))
    for name in ("NITRIF", "pco2surf", "POC_FLUX_IN"):
        assert hist[name].shape == np.asarray(hdiags[name]).shape, name
        np.testing.assert_allclose(hist[name], np.asarray(hdiags[name]),
                                   rtol=1e-12, atol=1e-18, err_msg=name)
    # the psum'd health counter rides the history as a replicated scalar
    assert hist["health_poc_error_cells"].ndim == 0
    assert float(hist["health_poc_error_cells"]) == float(
        np.asarray(hdiags["health_poc_error_cells"]))

    # ---- production rehearsal (VERDICT r4 item 6): the worker composed
    # restore -> sharded forced run (hold interp, per-record env) ->
    # selective history + health -> checkpoint -> bitwise continuation.
    # Verify its final state and second history against the identical
    # single-process composition. ----
    import dataclasses as _dc

    from ocean_bgc.models.forcing_series import (run_forced,
                                                 stack_forcings)

    forcing2 = _dc.replace(
        forcing,
        sst=forcing.sst + 0.5,
        potential_temperature=forcing.potential_temperature + 0.5,
        shortwave_surface=forcing.shortwave_surface * 1.1)
    series = stack_forcings([forcing, forcing2])
    prod, _ = run_forced(s2, grid, series, params, 3600.0, 4,
                         2 * 3600.0, interp="hold", env_mode="hold")
    prod2, pdiags = step(prod, grid, forcing, params, 3600.0,
                         compute_diags=True, health=True,
                         diag_filter=("NITRIF", "pco2surf",
                                      "POC_FLUX_IN"))
    # 7 coupled steps of separation amplify the shard-refusion ulps;
    # the envelope below is far under any physical signal
    np.testing.assert_allclose(got_prod, np.asarray(prod2.bgc.tracers),
                               rtol=1e-9, atol=1e-15)
    hist2 = stitch_history_shards(str(tmp_path / "history2"))
    for name in ("NITRIF", "pco2surf", "POC_FLUX_IN"):
        np.testing.assert_allclose(hist2[name], np.asarray(pdiags[name]),
                                   rtol=1e-8, atol=1e-14, err_msg=name)
