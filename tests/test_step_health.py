"""Production-step health counters (step(..., health=True)).

The reference's failure philosophy is silent fall-through: pH-solver
non-convergence is swallowed (co2calc.F90:993-995) and the QA-ballast
``poc_error`` flag is set but never read (BGC_mod.F90:2296-2297).  The
health counters make both observable from a production (diags-off) step
as two psum-able scalars.
"""

import dataclasses

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

DT = 3600.0
HKEYS = ("health_solver_nonconverged_cells", "health_poc_error_cells")


def test_health_clean_world_zero_counts():
    """A well-posed world: solver converges everywhere, the ballast
    bound holds, and enabling health does not perturb the state
    (bitwise)."""
    state, grid, forcing = synthetic_world(nlev=8, ncol=16, seed=5,
                                           ragged=True)
    params = ModelParams()
    s_h, d = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                    compute_diags=False,
                                    health=True))(state)
    for k in HKEYS:
        assert k in d
        assert float(d[k]) == 0.0, f"{k} nonzero on a healthy world"
    s0, d0 = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                    compute_diags=False))(state)
    assert not d0
    np.testing.assert_array_equal(np.asarray(s_h.bgc.tracers),
                                  np.asarray(s0.bgc.tracers))


def test_health_detects_solver_nonconvergence():
    """An alkalinity far outside anything the bracket-growing solver can
    root (TA >> DIC) leaves cells whose residual still implies a Newton
    correction above tolerance — the counter must see them."""
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=7,
                                           ragged=False)
    trc = np.asarray(state.bgc.tracers).copy()
    trc[:, T.ALK, :4] = 60000.0       # absurd: no root near seawater pH
    state = dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc,
                                       tracers=jnp.asarray(trc)))
    params = ModelParams()
    _, d = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                  compute_diags=False,
                                  health=True))(state)
    assert float(d["health_solver_nonconverged_cells"]) > 0.0


def test_health_poc_counter_matches_debug_report():
    """The in-graph poc_error counter equals the post-hoc
    utils/debug.poc_bounds_report computed from the emitted production
    diagnostics (same formula, BGC_mod.F90:2296-2297)."""
    from ocean_bgc.utils.debug import poc_bounds_report

    state, grid, forcing = synthetic_world(nlev=10, ncol=12, seed=9,
                                           ragged=True)
    params = ModelParams()
    _, d = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                  compute_diags=True,
                                  health=True))(state)
    report = poc_bounds_report(d)
    # the debug report scans ALL cells; mask to active ones like the
    # counter does
    active = np.asarray(grid.active_mask())
    from ocean_bgc.ops.particulates import RHO_CACO3, RHO_SIO2
    avail = (np.asarray(d["POC_PROD"])
             - RHO_CACO3 * np.asarray(d["CaCO3_PROD"])
             - RHO_SIO2 * np.asarray(d["SiO2_PROD"]))
    want = int((active & (avail < 0.0)).sum())
    assert int(float(d["health_poc_error_cells"])) == want
    assert report["n_violating_cells"] >= want


def test_health_sharded_psum():
    """make_sharded_step(health=True): the psum'd global counters equal
    the unsharded ones, with compute_diags=False (the production
    shape)."""
    from ocean_bgc.parallel import (make_mesh, make_sharded_step,
                                    shard_world)

    state, grid, forcing = synthetic_world(nlev=6, ncol=16, seed=3,
                                           ragged=True)
    trc = np.asarray(state.bgc.tracers).copy()
    trc[:, T.ALK, :2] = 60000.0       # make the counter nonzero
    state = dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc,
                                       tracers=jnp.asarray(trc)))
    params = ModelParams()

    _, want = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                     compute_diags=False,
                                     health=True))(state)

    mesh = make_mesh()
    ss, gg, ff = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, params, DT, compute_diags=False,
                           health=True)
    _, got = fn(ss, gg, ff)
    for k in HKEYS:
        assert float(got[k]) == float(want[k]), k
    assert float(got["health_solver_nonconverged_cells"]) > 0.0
