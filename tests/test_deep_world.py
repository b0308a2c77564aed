"""Deep-ocean acceptance gates: a representative 60-level ragged world.

Round-1's trajectory gates ran on 6-level (~515 m) toy worlds, so the
deep-ocean physics — the >3300 m lysocline no-burial rule
(BGC_mod.F90:2561-2565), sustained anoxic-bottom remineralization
(BGC_mod.F90:2599-2604), the NO3<5 sedimentary-denitrification gate, the
high-flux bSi burial-efficiency branch, and the deepest dissolution
scale-length knots (1700 m, BGC_parms.F90:540-541) — was never
oracle-checked.  This module adds

1. directed single-step oracle pins, one per bottom-cell branch, on
   worlds constructed so each branch PROVABLY fires (asserted from the
   oracle's captured bottom fluxes / the constructed inputs), and
2. a 60-level ragged trajectory gate vs the scalar oracle
   (OCEAN_BGC_DEEP_STEPS steps; default 24, acceptance runs use 120+).
"""

import dataclasses
import os

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.constants import LYSOCLINE_DEPTH, SPD
from ocean_bgc.models.coupled import run
from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world
from tests.oracle import bgc_ref
from tests.oracle.coupled_ref import coupled_step_ref

DEEP_STEPS = int(os.environ.get("OCEAN_BGC_DEEP_STEPS", "24"))
DT = 3600.0

MPERCM = 0.01


def _grid_dict(grid):
    return dict(
        cell_center_depth=np.asarray(grid.cell_center_depth),
        cell_thickness=np.asarray(grid.cell_thickness),
        cell_bottom_depth=np.asarray(grid.cell_bottom_depth),
        latitude=np.asarray(grid.latitude),
        kmax=np.asarray(grid.kmax),
    )


def _forcing_dict(forcing, fields=None):
    fields = fields or (
        "potential_temperature", "salinity", "dust_flux_in",
        "shortwave_surface", "fesedflux", "nutr_restore_rtau",
        "no3_clim", "po4_clim", "sio3_clim")
    return {f: np.asarray(getattr(forcing, f)) for f in fields}


def _deep_world(ncol=6):
    """A 60-level world (bottom 4530 m) with per-column bottom conditions
    chosen to fire one particulate bottom-cell branch each:

    col 0: full depth (4530 m > 3300 m)  -> lysocline: CaCO3 NOT buried
    col 1: kmax=40 (1403 m < 3300 m)     -> CaCO3 burial branch
    col 2: full depth, bottom O2 < 1     -> anoxic other_remin branch
    col 3: full depth, bottom NO3 < 5    -> sed-denitrif gate closes
    col 4: full depth, huge diatom load  -> bSi burial eff = 0.2 branch
    col 5: full depth, modest biology    -> bSi burial eff = 0.04 branch

    All full-depth columns also exercise the deepest dissolution
    scale-length knot (1700 m): their bottom 17 levels interpolate/clamp
    beyond it.
    """
    state, grid, forcing = synthetic_world(nlev=60, ncol=ncol, seed=11,
                                           ragged=False)
    kmax = np.full(ncol, 60, dtype=np.int32)
    kmax[1] = 40
    grid = dataclasses.replace(grid, kmax=jnp.asarray(kmax))

    trc = np.asarray(state.bgc.tracers).copy()
    # col 2: anoxic bottom water (and NO3 comfortably above the gate)
    trc[50:, T.O2, 2] = 0.4
    trc[50:, T.NO3, 2] = 20.0
    # col 3: NO3 below the 5 mmol/m^3 sed-denitrif gate at the bottom
    trc[55:, T.NO3, 3] = 1.0
    # col 4: a huge diatom bloom through the whole column so the bottom
    # bSi flux exceeds the 2 mmol/m^2/day burial-efficiency threshold
    trc[:, T.DIATC, 4] = 400.0
    trc[:, T.DIATCHL, 4] = 80.0
    trc[:, T.DIATFE, 4] = 2e-3
    trc[:, T.DIATSI, 4] = 400.0
    trc[:, T.ZOOC, 4] = 50.0
    trc[:, T.SIO3, 4] = 150.0
    trc[:, T.FE, 4] = 1e-3

    state = dataclasses.replace(
        state, bgc=dataclasses.replace(
            state.bgc, tracers=jnp.asarray(trc)))
    return state, grid, forcing


def _run_both(state, grid, forcing, params):
    out = bgc_source_sink(
        state.bgc.tracers, grid, forcing, state.bgc.ph_prev_3d,
        state.bgc.ph_prev_alt_3d, params.bgc)
    want = bgc_ref.bgc_source_sink_ref(
        np.asarray(state.bgc.tracers), _grid_dict(grid),
        _forcing_dict(forcing), np.asarray(state.bgc.ph_prev_3d),
        np.asarray(state.bgc.ph_prev_alt_3d), params.bgc)
    return out, want


def test_deep_bottom_branches_match_oracle():
    state, grid, forcing = _deep_world()
    params = ModelParams()
    out, (want_tend, want_ph, _, want_diags) = _run_both(
        state, grid, forcing, params)
    kmax = np.asarray(grid.kmax)
    zbot = np.asarray(grid.cell_bottom_depth)
    cols = np.arange(kmax.size)
    kb = kmax - 1

    # --- every branch actually fired (from the oracle's captured
    # bottom fluxes and the constructed inputs) ---
    assert zbot[kb[0], 0] > LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][0] > 0.0, \
        "no CaCO3 flux reaches the deep bottom; world not representative"
    assert zbot[kb[1], 1] < LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][1] > 0.0
    trc = np.asarray(state.bgc.tracers)
    assert trc[kb[2], T.O2, 2] < 1.0 and trc[kb[2], T.NO3, 2] >= 5.0
    assert trc[kb[3], T.NO3, 3] < 5.0
    assert want_diags["_poc_flux_out_bot"][3] > 0.0
    sio2_alt_day = want_diags["_sio2_flux_out_bot"] * MPERCM * SPD
    assert sio2_alt_day[4] > 2.0, \
        f"bSi flux {sio2_alt_day[4]:.3f} below the 0.2-eff threshold"
    assert 0.0 < sio2_alt_day[5] < 2.0

    got = {k: np.asarray(out.diags[k]) for k in
           ("calcToSed", "bsiToSed", "SedDenitrif", "OtherRemin",
            "pocToSed")}

    # --- branch signatures, in BOTH implementations ---
    # lysocline: nothing buried below 3300 m, burial above it
    assert got["calcToSed"][kb[0], 0] == 0.0
    assert want_diags["calcToSed"][kb[0], 0] == 0.0
    assert got["calcToSed"][kb[1], 1] > 0.0
    # NO3 gate: no sedimentary denitrification at col 3's bottom
    assert got["SedDenitrif"][kb[3], 3] == 0.0
    assert got["SedDenitrif"][kb[2], 2] > 0.0
    # anoxic bottom: other_remin takes the full-residual branch; verify
    # it EXCEEDS the oxic formula's cap, which discriminates the branch
    dz_b = np.asarray(grid.cell_thickness)[kb[2], 2]
    pf = want_diags["_poc_flux_out_bot"][2]
    fa2 = pf * 1e-6 * SPD * 365.0
    oxic_cap = min(0.1 + fa2, 0.5) * (pf - want_diags["pocToSed"][kb[2], 2])
    assert got["OtherRemin"][kb[2], 2] > oxic_cap * (1 + 1e-9), \
        "anoxic branch did not lift other_remin above the oxic cap"
    # bSi burial efficiency: back out eff = bsiToSed / (bury * flux_out)
    eff = (want_diags["bsiToSed"][kb, cols]
           / (params.bgc.parm_BSIbury
              * np.maximum(want_diags["_sio2_flux_out_bot"], 1e-300)))
    np.testing.assert_allclose(eff[4], 0.2, rtol=1e-12)
    np.testing.assert_allclose(eff[5], 0.04, rtol=1e-12)

    # --- full-field oracle pins (the actual parity gate) ---
    np.testing.assert_allclose(np.asarray(out.tendencies), want_tend,
                               rtol=1e-9, atol=1e-22)
    for name in ("calcToSed", "bsiToSed", "SedDenitrif", "OtherRemin",
                 "pocToSed"):
        np.testing.assert_allclose(got[name], want_diags[name],
                                   rtol=1e-9, atol=1e-22, err_msg=name)
    h_got = 10.0 ** (-np.asarray(out.ph_prev_3d))
    h_want = 10.0 ** (-want_ph)
    np.testing.assert_allclose(h_got, h_want, rtol=2e-5, atol=3e-10)


def test_deep_ragged_trajectory_matches_oracle():
    """THE flagship acceptance gate (BASELINE.md correctness gate): the
    coupled f64 trajectory vs the scalar oracle on the 60-level ragged
    world whose bottom cells fire EVERY particulate bottom-cell branch —
    lysocline no-burial (BGC_mod.F90:2561-2565), CaCO3 burial, anoxic
    other_remin (:2599-2604), the NO3<5 sed-denitrif gate, both bSi
    burial efficiencies — plus a 12-level shelf and a land column.
    Branch firing is ASSERTED at t=0 (below), so the acceptance number
    certifies the physics the round-1 toy world never reached.  Run with
    OCEAN_BGC_DEEP_STEPS=1000 for the full gate (passes; 165 s on this
    image, 2026-08-20 — recorded in BASELINE.md)."""
    state, grid, forcing = _deep_world(ncol=8)
    kmax = np.asarray(grid.kmax).copy()
    kmax[6] = 12   # shelf column
    kmax[7] = 0    # land column
    grid = dataclasses.replace(grid, kmax=jnp.asarray(kmax))
    params = ModelParams()

    # --- the world is representative: every bottom branch fires at the
    # trajectory's starting point, in BOTH implementations ---
    out0, (_, _, _, want_diags) = _run_both(state, grid, forcing, params)
    zbot = np.asarray(grid.cell_bottom_depth)
    kb = kmax - 1
    assert zbot[kb[0], 0] > LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][0] > 0.0
    got0 = {k: np.asarray(out0.diags[k]) for k in
            ("calcToSed", "SedDenitrif", "OtherRemin", "bsiToSed")}
    assert got0["calcToSed"][kb[0], 0] == 0.0          # lysocline
    assert got0["calcToSed"][kb[1], 1] > 0.0           # burial branch
    assert got0["SedDenitrif"][kb[2], 2] > 0.0         # denitrif on
    assert got0["SedDenitrif"][kb[3], 3] == 0.0        # NO3 gate closed
    assert got0["OtherRemin"][kb[2], 2] > 0.0          # anoxic branch
    eff = (want_diags["bsiToSed"][kb[:6], np.arange(6)]
           / (params.bgc.parm_BSIbury
              * np.maximum(want_diags["_sio2_flux_out_bot"][:6],
                           1e-300)))
    np.testing.assert_allclose(eff[4], 0.2, rtol=1e-12)   # high-flux
    np.testing.assert_allclose(eff[5], 0.04, rtol=1e-12)  # low-flux

    final, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, DEEP_STEPS))(state)

    gd = _grid_dict(grid)
    fd = _forcing_dict(forcing, fields=(
        "potential_temperature", "salinity", "dust_flux_in",
        "shortwave_surface", "surface_pressure", "ice_fraction",
        "wind_speed_squared_10m", "atm_co2", "atm_co2_alt",
        "surface_depth", "sst", "sss", "fesedflux", "nutr_restore_rtau",
        "no3_clim", "po4_clim", "sio3_clim"))
    ostate = dict(
        tracers=np.asarray(state.bgc.tracers),
        ph_prev=np.asarray(state.bgc.ph_prev_3d),
        ph_prev_alt=np.asarray(state.bgc.ph_prev_alt_3d),
        surface_ph=np.asarray(state.bgc.surface_ph),
        surface_ph_alt=np.asarray(state.bgc.surface_ph_alt),
        dms=np.asarray(state.dms),
        macros=np.asarray(state.macros),
    )
    for _ in range(DEEP_STEPS):
        ostate = coupled_step_ref(ostate, gd, fd, params, DT)

    got = np.asarray(final.bgc.tracers)
    want = ostate["tracers"]
    if DEEP_STEPS <= 120:
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
                                   ostate["macros"], rtol=5e-7,
                                   atol=1e-18)
    else:
        # long horizon: chaos-yardstick bound (see test_trajectory.py)
        pert = dataclasses.replace(
            state, bgc=dataclasses.replace(
                state.bgc, tracers=state.bgc.tracers * (1.0 + 1e-15)))
        final_p, _ = jax.jit(
            lambda s: run(s, grid, forcing, params, DT, DEEP_STEPS))(pert)
        yardstick = np.abs(np.asarray(final_p.bgc.tracers) - got)
        for idx in range(T.CNT):
            mismatch = np.abs(got[:, idx] - want[:, idx])
            bound = (10.0 * yardstick[:, idx].max()
                     + 2e-4 * np.abs(want[:, idx]).max() + 1e-12)
            assert mismatch.max() <= bound, (
                f"tracer {idx}: mismatch {mismatch.max():.3e} exceeds "
                f"chaos-bounded tolerance {bound:.3e}")
    h_got = 10.0 ** (-np.asarray(final.bgc.ph_prev_3d))
    h_want = 10.0 ** (-ostate["ph_prev"])
    np.testing.assert_allclose(h_got, h_want, rtol=5e-5, atol=5e-10)
