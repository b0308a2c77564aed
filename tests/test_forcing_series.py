"""Time-varying forcing: in-scan interpolation vs explicit host loop."""

import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.models.forcing_series import (
    forcing_at,
    forcing_record,
    load_forcing_series,
    run_forced,
    save_forcing_series,
    stack_forcings,
)
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world

DT = 3600.0


def _series(nlev, ncol, nrec):
    worlds = [synthetic_world(nlev=nlev, ncol=ncol, seed=100 + r)
              for r in range(nrec)]
    state, grid, _ = worlds[0]
    series = stack_forcings([w[2] for w in worlds])
    return state, grid, series, [w[2] for w in worlds]


def test_forcing_at_endpoints_and_blend():
    _, _, series, records = _series(4, 6, 3)
    f0 = forcing_at(series, 0.0)
    np.testing.assert_array_equal(np.asarray(f0.sst),
                                  np.asarray(records[0].sst))
    f2 = forcing_at(series, 99.0)   # clamped to the last record
    np.testing.assert_array_equal(np.asarray(f2.sst),
                                  np.asarray(records[2].sst))
    fm = forcing_at(series, 0.5)
    np.testing.assert_allclose(
        np.asarray(fm.salinity),
        0.5 * (np.asarray(records[0].salinity)
               + np.asarray(records[1].salinity)))
    fr = forcing_record(series, 1)
    np.testing.assert_array_equal(np.asarray(fr.ice_fraction),
                                  np.asarray(records[1].ice_fraction))


def test_run_forced_matches_host_loop():
    nlev, ncol, nrec, nsteps = 4, 6, 3, 8
    state, grid, series, _ = _series(nlev, ncol, nrec)
    params = ModelParams()
    record_dt = 4 * DT

    final, _ = jax.jit(lambda s: run_forced(
        s, grid, series, params, DT, nsteps, record_dt))(state)

    # host-side reference: interpolate outside, step inside
    s = state
    for i in range(nsteps):
        f = forcing_at(series, (i + 0.5) * DT / record_dt)
        s, _ = step(s, grid, f, params, DT, compute_diags=False)
    np.testing.assert_allclose(np.asarray(final.bgc.tracers),
                               np.asarray(s.bgc.tracers),
                               rtol=1e-12, atol=1e-18)


def test_run_forced_hold_mode():
    state, grid, series, records = _series(4, 6, 3)
    params = ModelParams()
    # with hold + record_dt exactly dt, step i uses record i
    final, _ = run_forced(state, grid, series, params, DT, 2, DT,
                          interp="hold")
    s = state
    for i in range(2):
        s, _ = step(s, grid, records[i], params, DT, compute_diags=False)
    np.testing.assert_allclose(np.asarray(final.bgc.tracers),
                               np.asarray(s.bgc.tracers),
                               rtol=1e-12, atol=1e-18)


def test_run_forced_env_hold_matches_uncached(monkeypatch):
    """env_mode='hold': the per-record coefficient cache (recomputed via
    lax.cond at record boundaries inside the scan) agrees with the
    recompute-every-step run to the same refusion-ulp class as run()'s
    constant-forcing cache — with the staleness guard ON the whole way,
    proving each record's cache matches the forcing the steps consume."""
    monkeypatch.setenv("OBGC_CHECK_ENV", "1")
    nlev, ncol, nrec, nsteps = 6, 8, 3, 9
    state, grid, series, _ = _series(nlev, ncol, nrec)
    params = ModelParams()
    record_dt = 3 * DT    # three steps per record: two boundary crossings

    a, _ = jax.jit(lambda s: run_forced(
        s, grid, series, params, DT, nsteps, record_dt,
        interp="hold", env_mode="hold"))(state)
    b, _ = jax.jit(lambda s: run_forced(
        s, grid, series, params, DT, nsteps, record_dt,
        interp="hold", env_mode="off"))(state)
    np.testing.assert_allclose(np.asarray(a.bgc.tracers),
                               np.asarray(b.bgc.tracers),
                               rtol=1e-10, atol=1e-280)
    np.testing.assert_allclose(np.asarray(a.bgc.ph_prev_3d),
                               np.asarray(b.bgc.ph_prev_3d),
                               rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(np.asarray(a.dms), np.asarray(b.dms),
                               rtol=1e-10, atol=1e-280)


def test_run_forced_env_interp_qualified():
    """env_mode='interp' under linear interpolation: blending the
    bracketing records' coefficient TABLES is a qualified approximation
    of computing coefficients from the blended (T, S).  The synthetic
    series' record-to-record jumps are far rougher than any monthly
    climatology (independent uniform draws), so the envelope here is a
    stress bound, not a best case."""
    nlev, ncol, nrec, nsteps = 6, 8, 3, 9
    state, grid, series, _ = _series(nlev, ncol, nrec)
    params = ModelParams()
    record_dt = 3 * DT

    a, _ = jax.jit(lambda s: run_forced(
        s, grid, series, params, DT, nsteps, record_dt,
        interp="linear", env_mode="interp"))(state)
    b, _ = jax.jit(lambda s: run_forced(
        s, grid, series, params, DT, nsteps, record_dt,
        interp="linear", env_mode="off"))(state)
    got, want = np.asarray(a.bgc.tracers), np.asarray(b.bgc.tracers)
    assert np.all(np.isfinite(got))
    # per-tracer relative envelope against the exact run
    for idx in range(got.shape[1]):
        scale = np.abs(want[:, idx]).max() + 1e-30
        err = np.abs(got[:, idx] - want[:, idx]).max() / scale
        assert err < 2e-3, f"tracer {idx}: interp-env error {err:.2e}"


def test_run_forced_env_mode_validation():
    state, grid, series, _ = _series(4, 6, 2)
    params = ModelParams()
    import pytest
    with pytest.raises(ValueError, match="exact only under"):
        run_forced(state, grid, series, params, DT, 1, DT,
                   interp="linear", env_mode="hold")
    with pytest.raises(ValueError, match="requires interp='linear'"):
        run_forced(state, grid, series, params, DT, 1, DT,
                   interp="hold", env_mode="interp")


def test_series_netcdf_round_trip(tmp_path):
    state, grid, series, _ = _series(4, 6, 3)
    p = os.path.join(tmp_path, "series.nc")
    save_forcing_series(p, series, record_dt=4 * DT)
    back, record_dt = load_forcing_series(p)
    assert record_dt == 4 * DT
    for a, b in zip(jax.tree.leaves(series), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
