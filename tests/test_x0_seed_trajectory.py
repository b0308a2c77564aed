"""Trajectory qualification of the opt-in previous-root solver seed
(OBGC_X0_SEED=1 — see ops/carbonate.py::x0_seed_enabled).

The seeded solve returns roots inside the same xacc tolerance ball as
the reference-sequence solve but not bitwise equal (~2e-4 relative in
H, the midpoint-seeded root's own error at the reference's loose
tolerance), so like OBGC_FAST_F64 it is qualified with the
perturbation-envelope methodology (tests/test_fp32_trajectory.py): the
x0 trajectory's divergence from the default f64 trajectory must stay
within the model's own response to a comparable initial-condition
perturbation — solver-tolerance noise, not bias.
"""

import dataclasses
import os

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax

from ocean_bgc.models.coupled import run
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS_X0", "48"))
DT = 3600.0


def test_x0_seed_trajectory_within_perturbation_envelope(monkeypatch):
    state, grid, forcing = synthetic_world(nlev=12, ncol=16, seed=23,
                                           ragged=True)
    params = ModelParams()

    monkeypatch.setenv("OBGC_X0_SEED", "0")
    final_ref, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(state)

    monkeypatch.setenv("OBGC_X0_SEED", "1")
    final_x0, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(state)

    # chaos yardstick: the default model's response to a 1e-11 relative
    # initial kick (the scale a ~2e-4 H-tolerance shift in the pH
    # warm-start state imprints on tracers through one surface-flux
    # evaluation is far below this)
    monkeypatch.setenv("OBGC_X0_SEED", "0")
    pert = dataclasses.replace(
        state, bgc=dataclasses.replace(
            state.bgc, tracers=state.bgc.tracers * (1.0 + 1e-11)))
    final_p, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(pert)

    got = np.asarray(final_x0.bgc.tracers)
    want = np.asarray(final_ref.bgc.tracers)
    yard = np.abs(np.asarray(final_p.bgc.tracers) - want)
    assert np.isfinite(got).all()
    assert not np.array_equal(got, want), \
        "x0 flag had no effect — the env knob is not reaching the trace"
    for idx in range(T.CNT):
        mismatch = np.abs(got[:, idx] - want[:, idx]).max()
        scale = np.abs(want[:, idx]).max() + 1e-30
        # solver-tolerance noise, chaos-amplified: the envelope is the
        # amplified-kick response plus a 0.1% relative allowance —
        # 10x tighter than the fp32 gate's, because only the pH state
        # (not every rounding) is perturbed
        bound = 30.0 * yard[:, idx].max() + 1e-3 * scale + 1e-12
        assert mismatch <= bound, (
            f"tracer {idx}: x0-seed mismatch {mismatch:.3e} exceeds "
            f"envelope {bound:.3e} (scale {scale:.3e})")


def test_x0_seed_conservation_unaffected(monkeypatch):
    """Carbon closure (Jint_Ctot) stays at the numerical floor with the
    seed on — the solver shift cannot leak mass (pH only feeds the
    carbonate speciation diagnostics and the surface gas flux, which
    the closure accounts)."""
    monkeypatch.setenv("OBGC_X0_SEED", "1")
    state, grid, forcing = synthetic_world(nlev=10, ncol=8, seed=7)
    params = ModelParams()
    _, diags = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, 6,
                      compute_diags=True))(state)
    scale = float(np.asarray(diags["photoC_TOT_zint"]).max()) + 1e-30
    resid = np.abs(np.asarray(diags["Jint_Ctot"]))
    assert (resid < 1e-10 * scale + 1e-18).all()
