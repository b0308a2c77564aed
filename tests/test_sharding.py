"""Column sharding over the virtual 8-device CPU mesh.

Exercises the exact multi-device path (shard_map + psum) that runs over
several GPUs, on the fake mesh (SURVEY.md par.4's multi-host test
strategy); ``python chip_smoke.py --four-cards`` runs it on four cards.
"""

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax

from ocean_bgc.models.coupled import step
from ocean_bgc.parallel import (make_mesh, make_pjit_step,
                                make_sharded_step, shard_world)
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world

DT = 3600.0


def test_sharded_step_matches_single_device():
    assert len(jax.devices()) == 8
    state, grid, forcing = synthetic_world(nlev=10, ncol=64, seed=11)
    params = ModelParams()

    # single-device reference
    ref_state, ref_diags = step(state, grid, forcing, params, DT)

    mesh = make_mesh()
    s_state, s_grid, s_forcing = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, params, DT, compute_diags=True)
    new_state, gdiags = fn(s_state, s_grid, s_forcing)

    np.testing.assert_allclose(
        np.asarray(new_state.bgc.tracers), np.asarray(ref_state.bgc.tracers),
        rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(
        np.asarray(new_state.dms), np.asarray(ref_state.dms), rtol=1e-12)
    # psum'd global sums equal the single-device column sums (the Jint
    # residuals are ~1e-16 numerical zeros whose exact value depends on
    # reduction order, hence the absolute tolerance)
    for name, val in gdiags.items():
        np.testing.assert_allclose(
            float(val), float(np.sum(np.asarray(ref_diags[name]))),
            rtol=1e-10, atol=1e-12, err_msg=name)


def test_pjit_step_matches_shard_map():
    state, grid, forcing = synthetic_world(nlev=8, ncol=32, seed=12)
    params = ModelParams()
    mesh = make_mesh()
    s_state, s_grid, s_forcing = shard_world(state, grid, forcing, mesh)

    f_sm = make_sharded_step(mesh, params, DT, compute_diags=True)
    f_pj = make_pjit_step(mesh, params, DT, compute_diags=True)
    st_sm, gd_sm = f_sm(s_state, s_grid, s_forcing)
    st_pj, gd_pj = f_pj(s_state, s_grid, s_forcing)

    np.testing.assert_allclose(np.asarray(st_sm.bgc.tracers),
                               np.asarray(st_pj.bgc.tracers), rtol=1e-12)
    for name in gd_sm:
        np.testing.assert_allclose(float(gd_sm[name]), float(gd_pj[name]),
                                   rtol=1e-9, atol=1e-18)


def test_multi_step_sharded():
    state, grid, forcing = synthetic_world(nlev=8, ncol=32, seed=13)
    params = ModelParams()
    mesh = make_mesh()
    s_state, s_grid, s_forcing = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, params, DT, compute_diags=True, nsteps=4)
    new_state, gdiags = fn(s_state, s_grid, s_forcing)
    assert np.isfinite(np.asarray(new_state.bgc.tracers)).all()
    assert np.isfinite(float(gdiags["photoC_TOT_zint"]))


def test_sharded_forced_run_matches_single_device():
    """run_forced under shard_map over the 8-device mesh == unsharded."""
    import jax.numpy as jnp
    from ocean_bgc.models.forcing_series import (run_forced,
                                                 stack_forcings)
    from ocean_bgc.parallel import (make_mesh,
                                    make_sharded_forced_run,
                                    shard_world)
    from ocean_bgc.parallel.sharding import col_sharding_tree

    nlev, ncol, nrec, nsteps = 4, 16, 3, 4
    worlds = [synthetic_world(nlev=nlev, ncol=ncol, seed=300 + r,
                              ragged=False) for r in range(nrec)]
    state, grid, _ = worlds[0]
    series = stack_forcings([w[2] for w in worlds])
    params = ModelParams()
    record_dt = 2 * 3600.0

    want, _ = run_forced(state, grid, series, params, 3600.0, nsteps,
                         record_dt)

    mesh = make_mesh()
    state_s, grid_s, _ = shard_world(state, grid, worlds[0][2], mesh)
    series_s = jax.device_put(series, col_sharding_tree(series, mesh))
    fn = make_sharded_forced_run(mesh, params, 3600.0, nsteps, record_dt)
    got = fn(state_s, grid_s, series_s)

    np.testing.assert_allclose(np.asarray(got.bgc.tracers),
                               np.asarray(want.bgc.tracers),
                               rtol=1e-12, atol=1e-18)

    # the per-record env cache composes with shard_map: each chip rolls
    # its own shard's tables forward at record boundaries (zero
    # collectives), agreeing with the unsharded uncached run at the
    # env cache's ulp-equivalence level
    want_h, _ = run_forced(state, grid, series, params, 3600.0, nsteps,
                           record_dt, interp="hold", env_mode="off")
    fn_h = make_sharded_forced_run(mesh, params, 3600.0, nsteps,
                                   record_dt, interp="hold",
                                   env_mode="hold")
    got_h = fn_h(state_s, grid_s, series_s)
    np.testing.assert_allclose(np.asarray(got_h.bgc.tracers),
                               np.asarray(want_h.bgc.tracers),
                               rtol=1e-10, atol=1e-280)

    # A/B: the GSPMD twin (make_pjit_forced_run — validation harness,
    # see its docstring) derives the same partitioned program
    from ocean_bgc.parallel import make_pjit_forced_run
    fn_pj = make_pjit_forced_run(mesh, params, 3600.0, nsteps,
                                 record_dt)
    got_pj = fn_pj(state_s, grid_s, series_s)
    np.testing.assert_allclose(np.asarray(got_pj.bgc.tracers),
                               np.asarray(want.bgc.tracers),
                               rtol=1e-12, atol=1e-18)


def test_sharded_local_diags_match_single_device():
    """make_sharded_step(local_diags=...): per-column diagnostic fields
    come back COLUMN-SHARDED (the pod history path — each process would
    write its addressable shards) and equal the unsharded step's values;
    the psum'd global sums still replicate."""
    from jax.sharding import NamedSharding

    from ocean_bgc.models.coupled import step as plain_step
    from ocean_bgc.parallel.sharding import (GLOBAL_SUM_DIAGS,
                                             _col_spec)

    ndev = len(jax.devices())
    state, grid, forcing = synthetic_world(nlev=6, ncol=16 * ndev,
                                           seed=31, ragged=True)
    params = ModelParams()
    keep = ("pco2surf", "NITRIF", "POC_FLUX_IN")

    mesh = make_mesh()
    s_state, s_grid, s_forcing = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, params, 3600.0, compute_diags=True,
                           local_diags=keep)
    new_state, gsums, local = fn(s_state, s_grid, s_forcing)
    assert set(local) == set(keep)
    assert set(gsums) == set(GLOBAL_SUM_DIAGS)

    _, want = plain_step(state, grid, forcing, params, 3600.0,
                         compute_diags=True)
    for name in keep:
        arr = local[name]
        assert isinstance(arr.sharding, NamedSharding)
        assert arr.sharding.spec == _col_spec(arr), name
        np.testing.assert_allclose(np.asarray(arr),
                                   np.asarray(want[name]),
                                   rtol=1e-12, atol=1e-20, err_msg=name)


def test_sharded_local_diags_global_sum_field():
    """A GLOBAL_SUM_DIAGS name selected in local_diags comes back as its
    column-sharded field (whose host sum is the psum'd total), not as
    the replicated scalar."""
    from ocean_bgc.parallel.sharding import _col_spec

    state, grid, forcing = synthetic_world(nlev=6, ncol=64, seed=32,
                                           ragged=True)
    mesh = make_mesh()
    sharded = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, ModelParams(), DT, compute_diags=True,
                           health=True,
                           local_diags=("photoC_TOT_zint",
                                        "health_poc_error_cells"))
    _, gsums, local = fn(*sharded)
    field = local["photoC_TOT_zint"]
    assert field.shape == (64,)
    assert field.sharding.spec == _col_spec(field)
    np.testing.assert_allclose(float(np.sum(np.asarray(field))),
                               float(gsums["photoC_TOT_zint"]), rtol=1e-12)
    assert local["health_poc_error_cells"].shape == ()


def test_distributed_initialize_single_process_is_noop(monkeypatch):
    """No arguments and no cluster environment: a single process, so
    initialize() decides explicitly to do nothing."""
    from ocean_bgc.parallel import distributed as dist

    def never(**kw):
        raise AssertionError("jax.distributed.initialize was called")

    monkeypatch.setattr(dist, "_cluster_env_present", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize", never)
    assert dist.initialize() is None


@pytest.mark.parametrize("cluster, kwargs", [
    (False, dict(coordinator_address="localhost:1", num_processes=2,
                 process_id=0)),
    (True, {}),
])
def test_distributed_initialize_failure_propagates(monkeypatch, cluster,
                                                   kwargs):
    """With arguments, or inside a cluster environment, the call goes to
    jax.distributed.initialize and its failure is not swallowed."""
    from ocean_bgc.parallel import distributed as dist

    seen = {}

    def failing(**kw):
        seen.update(kw)
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "_cluster_env_present", lambda: cluster)
    monkeypatch.setattr(jax.distributed, "initialize", failing)
    with pytest.raises(RuntimeError, match="unreachable"):
        dist.initialize(**kwargs)
    assert seen == {**dict(coordinator_address=None, num_processes=None,
                           process_id=None), **kwargs}
