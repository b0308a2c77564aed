"""Numerical-health checks — the framework's sanitizer layer.

The reference's failure philosophy is "never abort" (SURVEY.md par.5):
solver non-convergence falls through silently, negative tracers are
clipped.  Those saturating guards are reproduced in the kernels (they are
part of the model's behavior); this module adds the *observability* the
Fortran lacks:

* :func:`validate_state` — finite/range checks over the state pytree,
  returning a structured report instead of crashing mid-run.
* :func:`solver_health` — re-runs the pH residual at the current
  warm-start state and reports residual magnitude / worst cell, i.e. the
  convergence mask the reference never exposes (co2calc.F90:993-995).
* :func:`checked_step` — wraps a step function with post-hoc validation,
  raising with a precise cell location on corruption (the moral
  equivalent of running under a race/NaN sanitizer).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np

import jax.numpy as jnp

from ocean_bgc.models.coupled import CoupledState
from ocean_bgc.ops.carbonate import carbonate_coeffs, talk
from ocean_bgc.state import BGCForcing, ColumnGrid
from ocean_bgc.constants import VOL_TO_MASS, DIC_MIN, ALK_MIN
from ocean_bgc.state import BGCTracers as T


class StateReport(NamedTuple):
    ok: bool
    n_nonfinite: int
    n_negative: int
    worst_field: str
    detail: Dict[str, Tuple[int, int]]   # field -> (nonfinite, negative)


def validate_state(state: CoupledState, grid: ColumnGrid) -> StateReport:
    """Count non-finite and negative entries per prognostic field on
    active cells.  (Small transient negatives are legal — the kernels
    clip them — but a growing count flags an unstable dt.)"""
    active = np.asarray(grid.active_mask())
    detail = {}
    fields = {
        "bgc.tracers": np.asarray(state.bgc.tracers),
        "dms": np.asarray(state.dms),
        "macros": np.asarray(state.macros),
    }
    for name, arr in fields.items():
        mask = active[:, None, :]
        vals = np.where(mask, arr, 0.0)
        detail[name] = (int((~np.isfinite(vals)).sum()),
                        int((vals < 0.0).sum()))
    n_bad = sum(v[0] for v in detail.values())
    n_neg = sum(v[1] for v in detail.values())
    worst = max(detail, key=lambda k: detail[k][0] * 10**9 + detail[k][1])
    return StateReport(ok=(n_bad == 0), n_nonfinite=n_bad,
                       n_negative=n_neg, worst_field=worst, detail=detail)


def solver_health(state: CoupledState, grid: ColumnGrid,
                  forcing: BGCForcing) -> Dict[str, float]:
    """Evaluate the total-alkalinity residual at the stored warm-start pH
    for every active cell: |residual|/|dTA/dH| is the Newton step the next
    solve would take — large values flag stale or failed warm starts."""
    trc = jnp.maximum(state.bgc.tracers, 0.0)
    depth_m = grid.cell_center_depth * 0.01
    k = jnp.arange(grid.nlev)[:, None]
    coeffs = carbonate_coeffs(depth_m, forcing.potential_temperature,
                              forcing.salinity, k > 0)
    dic = jnp.maximum(trc[:, T.DIC], DIC_MIN) * VOL_TO_MASS
    ta = jnp.maximum(trc[:, T.ALK], ALK_MIN) * VOL_TO_MASS
    pt = trc[:, T.PO4] * VOL_TO_MASS
    sit = trc[:, T.SIO3] * VOL_TO_MASS
    h = 10.0 ** (-jnp.where(state.bgc.ph_prev_3d != 0.0,
                            state.bgc.ph_prev_3d, 8.0))
    fn, df = talk(coeffs, dic, ta, pt, sit, h)
    newton_step = jnp.abs(fn / df)
    active = grid.active_mask() & (state.bgc.ph_prev_3d != 0.0)
    step_np = np.where(np.asarray(active), np.asarray(newton_step), 0.0)
    return {
        "max_newton_step_h": float(step_np.max()),
        "mean_newton_step_h": float(step_np.mean()),
        "cells_checked": int(np.asarray(active).sum()),
    }


def poc_bounds_report(diags: Dict) -> Dict[str, float]:
    """The reference's ``poc_error`` flag as an observable.

    ``compute_particulate_terms`` sets ``poc_error = .true.`` when the
    POC production available for QA ballast goes negative —
    ``POC_PROD - rho_CaCO3*CaCO3_PROD - rho_SiO2*SiO2_PROD < 0``
    (BGC_mod.F90:2296-2297, 2373-2383) — and then never reads the flag.
    This reports the same condition from the emitted production
    diagnostics: violation count, worst deficit, and the flag itself,
    so a host can actually monitor what the Fortran silently records.
    """
    from ocean_bgc.ops.particulates import RHO_CACO3, RHO_SIO2

    avail = (np.asarray(diags["POC_PROD"])
             - RHO_CACO3 * np.asarray(diags["CaCO3_PROD"])
             - RHO_SIO2 * np.asarray(diags["SiO2_PROD"]))
    viol = avail < 0.0
    return {
        "poc_error": bool(viol.any()),
        "n_violating_cells": int(viol.sum()),
        "min_poc_prod_avail": float(avail.min()) if avail.size else 0.0,
    }


def checked_step(step_fn: Callable, grid: ColumnGrid) -> Callable:
    """Wrap a step callable; raises FloatingPointError naming the first
    corrupted field if the output state contains non-finite values."""

    def wrapped(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        new_state = out[0] if isinstance(out, tuple) else out
        report = validate_state(new_state, grid)
        if not report.ok:
            raise FloatingPointError(
                f"non-finite state after step: {report.n_nonfinite} "
                f"entries, worst field {report.worst_field!r} "
                f"(detail: {report.detail})")
        return out

    return wrapped
