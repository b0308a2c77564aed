"""Time-averaged history accumulation and IO; distributed helpers."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax

from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.parallel import distributed as dist
from ocean_bgc.parallel import make_mesh, shard_world
from ocean_bgc.utils.history import (TavgState, read_history,
                                     write_history)
from ocean_bgc.utils.synthetic import synthetic_world


def test_tavg_accumulates_means(tmp_path):
    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=81)
    params = ModelParams()
    fields = ("photoC_TOT", "pH_3D", "Jint_Ctot", "pco2surf")

    s, diags = step(state, grid, forcing, params, 3600.0)
    tavg = TavgState.create(diags, fields)

    @jax.jit
    def advance(s, tavg):
        s2, d = step(s, grid, forcing, params, 3600.0)
        return s2, tavg.accumulate(d)

    collected = []
    for _ in range(4):
        s, tavg = advance(s, tavg)
        collected.append(None)
    assert int(tavg.count) == 4

    # means equal the arithmetic mean of the per-step diags
    s_chk, d1 = step(state, grid, forcing, params, 3600.0)
    manual = {n: np.zeros_like(np.asarray(d1[n])) for n in fields}
    sc = s_chk
    for _ in range(4):
        sc, d = step(sc, grid, forcing, params, 3600.0)
        for n in fields:
            manual[n] += np.asarray(d[n])
    means = {n: np.asarray(v) for n, v in tavg.means().items()}
    for n in fields:
        # atol floor: Jint_* are ~1e-18 conservation-residual zeros
        np.testing.assert_allclose(means[n], manual[n] / 4, rtol=1e-12,
                                   atol=1e-15)

    path = write_history(str(tmp_path / "hist"), tavg,
                         attrs={"run": "test"})
    means2, count, meta = read_history(path)
    assert count == 4
    np.testing.assert_allclose(means2["photoC_TOT"], means["photoC_TOT"])
    assert meta["__units__pH_3D"] == "pH"
    assert meta["__attr__run"] == "test"

    reset = tavg.reset()
    assert int(reset.count) == 0
    assert float(np.abs(np.asarray(reset.sums["pH_3D"])).max()) == 0.0


def test_tavg_rejects_unknown_fields():
    state, grid, forcing = synthetic_world(nlev=4, ncol=4, seed=82)
    _, diags = step(state, grid, forcing, ModelParams(), 3600.0)
    import pytest
    with pytest.raises(KeyError):
        TavgState.create(diags, ["nope"])


def test_host_local_columns_single_process():
    mesh = make_mesh()
    lo, hi = dist.host_local_columns(64, mesh)
    assert (lo, hi) == (0, 64)   # single process owns everything


def test_host_local_to_global_roundtrip():
    state, grid, forcing = synthetic_world(nlev=4, ncol=32, seed=83)
    mesh = make_mesh()
    g = dist.host_local_to_global(
        {"x": np.asarray(state.bgc.tracers)}, mesh, 32)
    np.testing.assert_array_equal(np.asarray(g["x"]),
                                  np.asarray(state.bgc.tracers))


def test_run_tavg_compiled_matches_manual():
    """run(..., tavg_fields=...) accumulates inside the compiled scan and
    equals the manual per-step mean of the same diagnostics."""
    from ocean_bgc.models.coupled import run

    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=84)
    params = ModelParams()
    fields = ("photoC_TOT", "pH_3D", "pco2surf")
    nsteps = 5

    final, diags, tavg = jax.jit(
        lambda s: run(s, grid, forcing, params, 3600.0, nsteps,
                      compute_diags=True, tavg_fields=fields))(state)
    assert int(tavg.count) == nsteps
    assert diags, "final-step diags missing"

    # manual trajectory with the same physics
    s = state
    manual = None
    for _ in range(nsteps):
        s, d = step(s, grid, forcing, params, 3600.0)
        if manual is None:
            manual = {n: np.asarray(d[n]).copy() for n in fields}
        else:
            for n in fields:
                manual[n] += np.asarray(d[n])
    np.testing.assert_allclose(
        np.asarray(final.bgc.tracers), np.asarray(s.bgc.tracers),
        rtol=1e-12, atol=1e-18)
    means = {n: np.asarray(v) for n, v in tavg.means().items()}
    for n in fields:
        np.testing.assert_allclose(means[n], manual[n] / nsteps,
                                   rtol=1e-9, atol=1e-15)
    # the emitted final diags equal the last step's diags
    _, dlast = step(final, grid, forcing, params, 3600.0)  # NOT this one
    # (diags describe the step that PRODUCED final, so compare via manual d)
    np.testing.assert_allclose(np.asarray(diags["pco2surf"]),
                               np.asarray(d["pco2surf"]),
                               rtol=1e-9, atol=1e-15)


def test_run_tavg_rejects_unknown_field():
    from ocean_bgc.models.coupled import run

    state, grid, forcing = synthetic_world(nlev=4, ncol=4, seed=85)
    import pytest
    with pytest.raises(KeyError):
        run(state, grid, forcing, ModelParams(), 3600.0, 2,
            tavg_fields=("not_a_diag",))


def test_run_forced_tavg():
    """run_forced with tavg_fields returns a TavgState over the series."""
    import dataclasses as dc

    from ocean_bgc.models.forcing_series import (run_forced,
                                                 stack_forcings)

    state, grid, forcing = synthetic_world(nlev=4, ncol=4, seed=86)
    params = ModelParams()
    warm = dc.replace(forcing,
                      sst=forcing.sst + 2.0,
                      potential_temperature=forcing.potential_temperature
                      + 2.0)
    series = stack_forcings([forcing, warm, forcing])
    final, diags, tavg = jax.jit(
        lambda s: run_forced(s, grid, series, params, 3600.0, 4,
                             record_dt=2 * 3600.0, compute_diags=True,
                             tavg_fields=("pco2surf",)))(state)
    assert int(tavg.count) == 4
    assert np.isfinite(np.asarray(tavg.means()["pco2surf"])).all()
    assert np.isfinite(np.asarray(final.bgc.tracers)).all()
    assert "pco2surf" in diags


def test_history_shards_single_process_roundtrip(tmp_path):
    """write_history_shards / stitch_history_shards: bitwise round trip
    of sharded + replicated + scalar fields, and loud failures on
    missing shards (the pod-history writer; the 2-process exercise is
    in tests/test_distributed_multiprocess.py)."""
    import jax.numpy as jnp
    import pytest

    from ocean_bgc.utils.history import (stitch_history_shards,
                                         write_history_shards)

    fields = {
        "NITRIF": jnp.arange(24.0).reshape(2, 12),
        "pco2surf": jnp.arange(12.0),
        "health_poc_error_cells": jnp.asarray(3.0),
    }
    write_history_shards(str(tmp_path), fields, process_index=0)
    got = stitch_history_shards(str(tmp_path))
    for name, v in fields.items():
        np.testing.assert_array_equal(got[name], np.asarray(v))

    # a gap in the column coverage must raise, not silently truncate:
    # a hand-written part file claiming 16 columns but holding 8
    import os

    d2 = tmp_path / "gappy"
    os.makedirs(d2)
    np.savez(d2 / "hist_p0.npz",
             **{"f@0": np.arange(8.0),
                "__shape__f": np.asarray([16], np.int64)})
    with pytest.raises(ValueError, match="missing"):
        stitch_history_shards(str(d2))
