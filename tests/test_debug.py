"""Numerical-health utilities: state validation, solver health, wrapping."""

import dataclasses

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.debug import (checked_step, solver_health,
                                   validate_state)
from ocean_bgc.utils.synthetic import synthetic_world


def test_validate_state_clean():
    state, grid, _ = synthetic_world(nlev=6, ncol=8, seed=51)
    rep = validate_state(state, grid)
    assert rep.ok and rep.n_nonfinite == 0


def test_validate_state_detects_nan():
    state, grid, _ = synthetic_world(nlev=6, ncol=8, seed=52)
    bad = state.bgc.tracers.at[0, 3, 2].set(jnp.nan)
    state = dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc, tracers=bad))
    rep = validate_state(state, grid)
    assert not rep.ok and rep.n_nonfinite == 1
    assert rep.worst_field == "bgc.tracers"


def test_solver_health_after_step():
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=53)
    s1, _ = step(state, grid, forcing, ModelParams(), 3600.0,
                 compute_diags=False)
    health = solver_health(s1, grid, forcing)
    assert health["cells_checked"] > 0
    # warm starts are converged solutions: Newton step below solver tol
    assert health["max_newton_step_h"] < 1e-9


def test_checked_step_raises_on_corruption():
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=54)
    params = ModelParams()

    def bad_step(s, *a, **kw):
        new, d = step(s, grid, forcing, params, 3600.0,
                      compute_diags=False)
        poisoned = new.bgc.tracers.at[0, 0, 0].set(jnp.inf)
        return dataclasses.replace(
            new, bgc=dataclasses.replace(new.bgc, tracers=poisoned)), d

    wrapped = checked_step(bad_step, grid)
    with pytest.raises(FloatingPointError, match="non-finite"):
        wrapped(state)

    ok_step = checked_step(
        lambda s: step(s, grid, forcing, params, 3600.0,
                       compute_diags=False), grid)
    out, _ = ok_step(state)
    assert np.isfinite(np.asarray(out.bgc.tracers)).all()


def test_poc_bounds_report():
    """The poc_error observable (BGC_mod.F90:2296-2383 equivalent)."""
    from ocean_bgc.models.coupled import step
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.debug import poc_bounds_report
    from ocean_bgc.utils.synthetic import synthetic_world

    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=91)
    _, diags = step(state, grid, forcing, ModelParams(), 3600.0)
    rep = poc_bounds_report(diags)
    assert set(rep) == {"poc_error", "n_violating_cells",
                        "min_poc_prod_avail"}
    # physically-plausible worlds satisfy the bound
    assert rep["poc_error"] is False and rep["n_violating_cells"] == 0

    # a manufactured violation is detected
    import numpy as np
    bad = dict(diags)
    bad["CaCO3_PROD"] = np.asarray(diags["CaCO3_PROD"]) + 1.0
    rep2 = poc_bounds_report(bad)
    assert rep2["poc_error"] is True and rep2["n_violating_cells"] > 0
    assert rep2["min_poc_prod_avail"] < 0.0
