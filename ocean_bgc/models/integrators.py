"""Higher-order time integrators for the coupled model.

The reference's host couples with forward Euler; these Runge-Kutta
schemes reuse :func:`~ocean_bgc.models.coupled.evaluate_tendencies`
as the right-hand side.  The pH warm-start fields are *solver hints*, not
ODE state: each stage warm-starts from the previous stage's solution, and
the final state carries the last stage's pH — the standard treatment of
algebraic/auxiliary variables in multi-stage schemes.

Forward Euler at dt is the reference-faithful default; RK2/RK4 buy
stability and accuracy at 2x/4x kernel evaluations per step (often a net
win: RK4 at 4*dt outruns Euler at dt).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax

from ocean_bgc.models.coupled import (
    CoupledState,
    apply_update,
    evaluate_tendencies,
)
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCForcing, ColumnGrid


def _with_ph(state: CoupledState, tend) -> CoupledState:
    """Carry a stage's pH warm-start fields onto a state."""
    return dataclasses.replace(
        state, bgc=dataclasses.replace(
            state.bgc,
            ph_prev_3d=tend.ph_prev_3d,
            ph_prev_alt_3d=tend.ph_prev_alt_3d,
            surface_ph=tend.surface_ph,
            surface_ph_alt=tend.surface_ph_alt))


def step_rk2(state: CoupledState, grid: ColumnGrid, forcing: BGCForcing,
             params: ModelParams, dt: float, *,
             compute_diags: bool = True, env=None, health: bool = False,
             diag_filter=None
             ) -> Tuple[CoupledState, Dict[str, jax.Array]]:
    """Heun's method (RK2): y' = y + dt/2 (k1 + k2).

    ``env``/``health``: as in :func:`~ocean_bgc.models.coupled
    .step` — the coefficient cache is valid for every stage (stages
    share the forcing snapshot); health counters come from the first
    (diagnostic-emitting) stage."""
    k1, diags = evaluate_tendencies(state, grid, forcing, params,
                                    compute_diags=compute_diags,
                                    env=env, health=health,
                                    diag_filter=diag_filter)
    mid = apply_update(state, k1, dt)
    k2, _ = evaluate_tendencies(mid, grid, forcing, params,
                                compute_diags=False, env=env)
    new = apply_update(
        state, k2, dt / 2.0,
        bgc_incr=k1.bgc + k2.bgc,
        dms_incr=k1.dms + k2.dms,
        macros_incr=k1.macros + k2.macros)
    return new, diags


def step_rk4(state: CoupledState, grid: ColumnGrid, forcing: BGCForcing,
             params: ModelParams, dt: float, *,
             compute_diags: bool = True, env=None, health: bool = False,
             diag_filter=None
             ) -> Tuple[CoupledState, Dict[str, jax.Array]]:
    """Classic RK4."""
    k1, diags = evaluate_tendencies(state, grid, forcing, params,
                                    compute_diags=compute_diags,
                                    env=env, health=health,
                                    diag_filter=diag_filter)
    s2 = apply_update(state, k1, dt / 2.0)
    k2, _ = evaluate_tendencies(s2, grid, forcing, params,
                                compute_diags=False, env=env)
    s3 = apply_update(_with_ph(state, k2), k2, dt / 2.0)
    k3, _ = evaluate_tendencies(s3, grid, forcing, params,
                                compute_diags=False, env=env)
    s4 = apply_update(_with_ph(state, k3), k3, dt)
    k4, _ = evaluate_tendencies(s4, grid, forcing, params,
                                compute_diags=False, env=env)
    new = apply_update(
        state, k4, dt / 6.0,
        bgc_incr=k1.bgc + 2.0 * k2.bgc + 2.0 * k3.bgc + k4.bgc,
        dms_incr=k1.dms + 2.0 * k2.dms + 2.0 * k3.dms + k4.dms,
        macros_incr=(k1.macros + 2.0 * k2.macros + 2.0 * k3.macros
                     + k4.macros))
    return new, diags


INTEGRATORS = {"euler": None, "rk2": step_rk2, "rk4": step_rk4}
