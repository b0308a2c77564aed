"""RK integrators: convergence order vs forward Euler."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax

from ocean_bgc.models.coupled import step
from ocean_bgc.models.integrators import step_rk2, step_rk4
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def _advance(step_fn, state, grid, forcing, params, dt, n):
    f = jax.jit(lambda s: step_fn(s, grid, forcing, params, dt,
                                  compute_diags=False)[0])
    for _ in range(n):
        state = f(state)
    return np.asarray(state.bgc.tracers)


def test_rk_converges_to_same_solution():
    """Euler at dt/4 and RK4 at dt land on the same trajectory; RK4's
    coarse-step error is far below Euler's at the same cost horizon."""
    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=61)
    params = ModelParams()
    T = 8 * 3600.0

    truth = _advance(step, state, grid, forcing, params, T / 64, 64)
    euler = _advance(step, state, grid, forcing, params, T / 8, 8)
    rk2 = _advance(step_rk2, state, grid, forcing, params, T / 8, 8)
    rk4 = _advance(step_rk4, state, grid, forcing, params, T / 8, 8)

    scale = np.abs(truth).max()
    err = lambda a: np.abs(a - truth).max() / scale  # noqa: E731
    e_euler, e_rk2, e_rk4 = err(euler), err(rk2), err(rk4)
    assert e_rk2 < 0.5 * e_euler, (e_euler, e_rk2)
    assert e_rk4 < 0.2 * e_euler, (e_euler, e_rk4)
    assert np.isfinite(rk4).all()


def test_rk4_jittable():
    state, grid, forcing = synthetic_world(nlev=4, ncol=4, seed=62)
    params = ModelParams()
    f = jax.jit(lambda s: step_rk4(s, grid, forcing, params, 1800.0,
                                   compute_diags=False)[0])
    out = f(state)
    assert np.isfinite(np.asarray(out.bgc.tracers)).all()
