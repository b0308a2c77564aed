"""Coupled model integration: stability, state threading, physical sanity."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import run, step
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

DT = 3600.0  # 1 h


def test_single_step_updates_state():
    state, grid, forcing, = synthetic_world(nlev=20, ncol=64, seed=3)
    params = ModelParams()
    new, diags = step(state, grid, forcing, params, DT)
    assert np.isfinite(np.asarray(new.bgc.tracers)).all()
    # warm-start pH fields populated on active cells
    active = np.asarray(grid.active_mask())
    ph = np.asarray(new.bgc.ph_prev_3d)
    assert (ph[active] > 6.0).all() and (ph[active] < 9.5).all()
    # land columns untouched
    kmax = np.asarray(grid.kmax)
    land = kmax == 0
    if land.any():
        np.testing.assert_array_equal(
            np.asarray(new.bgc.tracers)[:, :, land],
            np.asarray(state.bgc.tracers)[:, :, land])
    # surface CO2 diags present and plausible
    pco2 = np.asarray(diags["pco2surf"])[~land]
    assert (pco2 > 100.0).all() and (pco2 < 1200.0).all()


def test_multi_step_run_is_stable():
    state, grid, forcing = synthetic_world(nlev=16, ncol=32, seed=4)
    params = ModelParams()
    final, diags = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, 48,
                      compute_diags=True))(state)
    trc = np.asarray(final.bgc.tracers)
    assert np.isfinite(trc).all()
    active = np.asarray(grid.active_mask())
    # prognostic fields remain in physical ranges after 2 days
    assert (trc[:, T.DIC][active] > 1500.0).all()
    assert (trc[:, T.DIC][active] < 3000.0).all()
    assert (trc[:, T.O2][active] > -1.0).all()
    assert np.isfinite(np.asarray(final.dms)).all()
    assert np.isfinite(np.asarray(final.macros)).all()
    # conservation closure holds at the final state too
    scale = float(np.abs(np.asarray(diags["photoC_TOT_zint"])).max()) + 1e-30
    assert np.abs(np.asarray(diags["Jint_Ctot"])).max() < 1e-9 * scale + 1e-17


def test_warm_start_threading():
    """After one step every active cell carries a pH warm start, and the
    second step's solve returns nearly the same pH (consistency of the
    warm-start path, BGC_mod.F90:943-956)."""
    state, grid, forcing = synthetic_world(nlev=12, ncol=24, seed=5)
    params = ModelParams()
    s1, _ = step(state, grid, forcing, params, DT)
    s2, _ = step(s1, grid, forcing, params, DT)
    active = np.asarray(grid.active_mask())
    ph1 = np.asarray(s1.bgc.ph_prev_3d)[active]
    ph2 = np.asarray(s2.bgc.ph_prev_3d)[active]
    assert np.abs(ph1 - ph2).max() < 0.05   # smooth trajectory, no jumps


def test_surface_flux_changes_only_top_cell():
    state, grid, forcing = synthetic_world(nlev=12, ncol=16, seed=6)
    params = ModelParams()
    # zero out all interior tendencies' drivers is impractical; instead
    # verify the net surface flux is deposited at k=0 only: compare a run
    # with doubled gas flux via doubled wind (quadratic piston velocity)
    import dataclasses
    forcing2 = dataclasses.replace(
        forcing,
        wind_speed_squared_10m=2.0 * forcing.wind_speed_squared_10m)
    s_a, _ = step(state, grid, forcing, params, DT)
    s_b, _ = step(state, grid, forcing2, params, DT)
    d = np.asarray(s_b.bgc.tracers - s_a.bgc.tracers)
    # O2 differs at the surface level
    assert np.abs(d[0, T.O2]).max() > 0.0
    # below the surface nothing in the O2 column changed
    np.testing.assert_array_equal(d[1:, T.O2], 0.0)


def test_diag_dtype_narrowing():
    """diag_dtype=f32 narrows only the emitted diagnostics; the state
    update and all diagnostic arithmetic stay in the state dtype."""
    import jax.numpy as jnp

    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=71)
    params = ModelParams()
    s64, d64 = step(state, grid, forcing, params, DT)
    s32, d32 = step(state, grid, forcing, params, DT,
                    diag_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(s64.bgc.tracers),
                                  np.asarray(s32.bgc.tracers))
    assert all(v.dtype == jnp.float32 for v in d32.values())
    for k in ("pco2surf", "photoC_TOT", "CO3"):
        np.testing.assert_allclose(np.asarray(d32[k]),
                                   np.asarray(d64[k]).astype(np.float32),
                                   rtol=0, atol=0)


def test_coupled_carbon_and_silicon_mass_balance():
    """End-to-end budget closure of the COUPLED step (not just the
    interior Jint identity): over one forward-Euler step, the change in
    each column's carbon inventory equals dt times

        Jint_Ctot  -  (pocToSed + calcToSed)  +  sum of C-tracer
                                                  surface net fluxes

    (the interior conservation integral, BGC_mod.F90:1875-1938, minus
    sediment burial, plus the air-sea/river/ice deposit that
    models/coupled.py adds to the top cell AFTER the kernel).  Same for
    silicon with bsiToSed.  This certifies the surface-flux deposition
    and the sediment bookkeeping against the tracer update itself,
    independent of the oracle."""
    state, grid, forcing = synthetic_world(nlev=12, ncol=10, seed=23,
                                           ragged=True)
    params = ModelParams()
    s1, d = jax.jit(lambda s: step(s, grid, forcing, params, DT,
                                   compute_diags=True))(state)

    dz = np.asarray(grid.cell_thickness)
    active = np.asarray(grid.active_mask())
    t0 = np.asarray(state.bgc.tracers)
    t1 = np.asarray(s1.bgc.tracers)

    c_idx = [T.DIC, T.DOC, T.ZOOC, T.SPC, T.DIATC, T.DIAZC, T.PHAEOC,
             T.SPCACO3]
    si_idx = [T.SIO3, T.DIATSI]

    def budget(idx_list, jint_name, sed_arrays):
        inv0 = sum((np.where(active, t0[:, i], 0.0) * dz).sum(axis=0)
                   for i in idx_list)
        inv1 = sum((np.where(active, t1[:, i], 0.0) * dz).sum(axis=0)
                   for i in idx_list)
        sed = sum(np.asarray(d[n]).sum(axis=0) for n in sed_arrays)
        # the deposit is gated on has_ocean (models/coupled.py); the
        # netFlux diagnostic itself is raw, so land columns get none
        has_ocean = np.asarray(grid.kmax) > 0
        sflux = np.where(has_ocean,
                         sum(np.asarray(d["netFlux"])[i]
                             for i in idx_list), 0.0)
        rhs = DT * (np.asarray(d[jint_name]) - sed + sflux)
        scale = np.abs(inv0).max()
        np.testing.assert_allclose(inv1 - inv0, rhs, rtol=0.0,
                                   atol=1e-10 * scale)

    budget(c_idx, "Jint_Ctot", ("pocToSed", "calcToSed"))
    budget(si_idx, "Jint_Sitot", ("bsiToSed",))


def test_diag_filter_subset_bitwise(rng):
    """step(diag_filter=...) returns exactly the requested diagnostics,
    bitwise-equal to the unfiltered run's (the filter only prunes what
    XLA materializes, never changes arithmetic); unknown names raise."""
    import pytest

    from ocean_bgc.utils.synthetic import synthetic_world

    state, grid, forcing = synthetic_world(nlev=6, ncol=12, seed=9,
                                           ragged=True)
    params = ModelParams()
    want_state, full = step(state, grid, forcing, params, 3600.0,
                            compute_diags=True)
    keep = ("pco2surf", "NITRIF", "POC_FLUX_IN", "photoC_TOT_zint",
            "DMS_S_TOTAL", "MACROS_PROT_S_TOTAL", "netFlux")
    got_state, got = step(state, grid, forcing, params, 3600.0,
                          compute_diags=True, diag_filter=keep)
    assert set(got) == set(keep)
    for k in keep:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(full[k]), err_msg=k)
    # the state update is untouched by the filter
    for a, b in zip(jax.tree.leaves(want_state),
                    jax.tree.leaves(got_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(KeyError, match="unknown diagnostics"):
        step(state, grid, forcing, params, 3600.0, compute_diags=True,
             diag_filter=("not_a_diag",))


def test_diag_filter_guard_rails(rng):
    """diag_filter without compute_diags raises (a silent no-op would
    mislabel a diags-off measurement as selective-diagnostics); health
    counters always survive the filter (run_model --health reads them
    every step)."""
    import pytest

    from ocean_bgc.utils.synthetic import synthetic_world

    state, grid, forcing = synthetic_world(nlev=4, ncol=8, seed=5)
    params = ModelParams()
    with pytest.raises(ValueError, match="compute_diags"):
        step(state, grid, forcing, params, 3600.0, compute_diags=False,
             diag_filter=("pco2surf",))
    _, d = step(state, grid, forcing, params, 3600.0,
                compute_diags=True, health=True,
                diag_filter=("pco2surf",))
    assert set(d) == {"pco2surf", "health_solver_nonconverged_cells",
                      "health_poc_error_cells"}
    # health names are also listable explicitly (no-op)
    _, d2 = step(state, grid, forcing, params, 3600.0,
                 compute_diags=True, health=True,
                 diag_filter=("pco2surf",
                              "health_poc_error_cells"))
    assert set(d2) == set(d)
