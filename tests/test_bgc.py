"""BGC ecosystem kernel vs the scalar oracle + conservation properties."""

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.params import BGCParams
from ocean_bgc.state import BGCForcing, BGCTracers as T, ColumnGrid
from tests.oracle import bgc_ref


def make_inputs(rng, nlev=8, ncol=6, lrest=False):
    """Physically-plausible random columns exercising the branchy paths."""
    trc = np.zeros((nlev, T.CNT, ncol))
    trc[:, T.PO4] = rng.uniform(0.01, 3.0, (nlev, ncol))
    trc[:, T.NO3] = rng.uniform(0.05, 35.0, (nlev, ncol))
    trc[:, T.SIO3] = rng.uniform(0.1, 150.0, (nlev, ncol))
    trc[:, T.NH4] = rng.uniform(0.0, 1.0, (nlev, ncol))
    trc[:, T.FE] = rng.uniform(0.0, 2e-3, (nlev, ncol))
    trc[:, T.O2] = rng.uniform(0.0, 350.0, (nlev, ncol))
    trc[:, T.DIC] = rng.uniform(1800.0, 2400.0, (nlev, ncol))
    trc[:, T.DIC_ALT_CO2] = rng.uniform(1800.0, 2400.0, (nlev, ncol))
    trc[:, T.ALK] = rng.uniform(2000.0, 2500.0, (nlev, ncol))
    trc[:, T.DOC] = rng.uniform(0.0, 100.0, (nlev, ncol))
    trc[:, T.DON] = rng.uniform(0.0, 10.0, (nlev, ncol))
    trc[:, T.DOFE] = rng.uniform(0.0, 1e-3, (nlev, ncol))
    trc[:, T.DOP] = rng.uniform(0.0, 0.5, (nlev, ncol))
    trc[:, T.DOPR] = rng.uniform(0.0, 0.2, (nlev, ncol))
    trc[:, T.DONR] = rng.uniform(0.0, 2.0, (nlev, ncol))
    trc[:, T.ZOOC] = rng.uniform(0.0, 2.0, (nlev, ncol))
    for g in range(4):
        trc[:, T.CHL_IND[g]] = rng.uniform(0.0, 1.0, (nlev, ncol))
        trc[:, T.C_IND[g]] = rng.uniform(0.0, 4.0, (nlev, ncol))
        trc[:, T.FE_IND[g]] = rng.uniform(0.0, 2e-5, (nlev, ncol))
    trc[:, T.DIATSI] = rng.uniform(0.0, 1.0, (nlev, ncol))
    trc[:, T.SPCACO3] = rng.uniform(0.0, 0.5, (nlev, ncol))
    # branch coverage: zeroed phyto pool, negative tracer, bloom sp
    trc[1, T.SPCHL, 0] = 0.0
    trc[2, T.NO3, 1] = -4.0
    trc[0, T.SPC, 2] = 6.0      # above CaCO3 bloom threshold

    dz = rng.uniform(500.0, 4000.0, (nlev, ncol))   # cm
    zbot = np.cumsum(dz, axis=0)
    zcen = zbot - 0.5 * dz
    kmax = rng.integers(1, nlev + 1, ncol)
    kmax[0] = nlev
    kmax[1] = 0                                     # land column
    lats = rng.uniform(-80.0, 80.0, ncol)
    lats[2] = 45.0
    lats[3] = -60.0

    grid = ColumnGrid(
        cell_center_depth=jnp.asarray(zcen),
        cell_thickness=jnp.asarray(dz),
        cell_bottom_depth=jnp.asarray(zbot),
        latitude=jnp.asarray(lats),
        kmax=jnp.asarray(kmax, dtype=jnp.int32),
    )
    temp = rng.uniform(-1.8, 31.0, (nlev, ncol))
    temp[:, 3] = rng.uniform(-1.8, 2.0, nlev)       # polar: diaz cutoff
    salt = rng.uniform(30.0, 38.0, (nlev, ncol))
    forcing = BGCForcing(
        potential_temperature=jnp.asarray(temp),
        salinity=jnp.asarray(salt),
        dust_flux_in=jnp.asarray(rng.uniform(0.0, 1e-9, ncol)),
        shortwave_surface=jnp.asarray(rng.uniform(0.0, 350.0, ncol)),
        surface_pressure=jnp.asarray(rng.uniform(0.95, 1.05, ncol)),
        ice_fraction=jnp.asarray(rng.uniform(-0.1, 1.1, ncol)),
        wind_speed_squared_10m=jnp.asarray(rng.uniform(0.0, 3e6, ncol)),
        atm_co2=jnp.asarray(rng.uniform(280.0, 1200.0, ncol)),
        atm_co2_alt=jnp.asarray(rng.uniform(280.0, 1200.0, ncol)),
        surface_depth=jnp.asarray(np.zeros(ncol)),
        sst=jnp.asarray(temp[0]),
        sss=jnp.asarray(salt[0]),
        fesedflux=jnp.asarray(rng.uniform(0.0, 1e-8, (nlev, ncol))),
        nutr_restore_rtau=jnp.asarray(
            rng.uniform(0.0, 1e-5, (nlev, ncol))),
        no3_clim=jnp.asarray(rng.uniform(0.0, 30.0, (nlev, ncol))),
        po4_clim=jnp.asarray(rng.uniform(0.0, 3.0, (nlev, ncol))),
        sio3_clim=jnp.asarray(rng.uniform(0.0, 100.0, (nlev, ncol))),
        deposition_flux=jnp.zeros((T.CNT, ncol)),
        river_flux=jnp.zeros((T.CNT, ncol)),
        seaice_flux=jnp.zeros((T.CNT, ncol)),
        gas_flux=jnp.zeros((T.CNT, ncol)),
    )
    params = BGCParams(lrest_po4=lrest, lrest_no3=lrest, lrest_sio3=lrest)
    ph_prev = np.zeros((nlev, ncol))
    ph_prev[:, 0] = 8.0 + rng.uniform(-0.3, 0.3, nlev)  # warm-started col
    ph_alt = np.zeros((nlev, ncol))
    return trc, grid, forcing, params, ph_prev, ph_alt


def _grid_dict(grid):
    return dict(
        cell_center_depth=np.asarray(grid.cell_center_depth),
        cell_thickness=np.asarray(grid.cell_thickness),
        cell_bottom_depth=np.asarray(grid.cell_bottom_depth),
        latitude=np.asarray(grid.latitude),
        kmax=np.asarray(grid.kmax),
    )


def _forcing_dict(forcing):
    return {f: np.asarray(getattr(forcing, f)) for f in (
        "potential_temperature", "salinity", "dust_flux_in",
        "shortwave_surface", "fesedflux", "nutr_restore_rtau",
        "no3_clim", "po4_clim", "sio3_clim")}


@pytest.mark.parametrize("lrest", [False, True])
def test_bgc_matches_oracle(rng, lrest):
    trc, grid, forcing, params, ph_prev, ph_alt = make_inputs(
        rng, lrest=lrest)
    out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                          jnp.asarray(ph_prev), jnp.asarray(ph_alt), params)
    want_tend, want_ph, want_ph_alt, want_diags = bgc_ref.bgc_source_sink_ref(
        trc, _grid_dict(grid), _forcing_dict(forcing), ph_prev, ph_alt,
        params)

    got_tend = np.asarray(out.tendencies)
    # tendencies do not depend on the pH solve -> near-bitwise agreement
    np.testing.assert_allclose(got_tend, want_tend, rtol=1e-9, atol=1e-22)

    # pH warm-start state agrees to solver tolerance (H-space)
    h_got = 10.0 ** (-np.asarray(out.ph_prev_3d))
    h_want = 10.0 ** (-want_ph)
    np.testing.assert_allclose(h_got, h_want, rtol=2e-5, atol=3e-10)

    for name in ("Jint_Ctot", "Jint_Ntot", "Jint_Ptot", "Jint_Sitot",
                 "Jint_100m_Ctot", "Jint_100m_Ntot", "Jint_100m_Ptot",
                 "Jint_100m_Sitot", "photoC_TOT_zint", "Chl_TOT_zint_100m",
                 "O2_ZMIN", "O2_ZMIN_DEPTH"):
        # the Jint fields are conservation residuals ~1e-17 whose exact
        # value depends on accumulation order -> absolute tolerance
        np.testing.assert_allclose(
            np.asarray(out.diags[name]), want_diags[name],
            rtol=1e-8, atol=1e-13, err_msg=name)
    for name in ("POC_FLUX_IN", "POC_REMIN", "NITRIF", "DENITRIF",
                 "PAR_avg", "tot_CaCO3_form", "pocToSed", "SedDenitrif"):
        np.testing.assert_allclose(
            np.asarray(out.diags[name]), want_diags[name],
            rtol=1e-9, atol=1e-22, err_msg=name)
    # POC_ACCUM is declared but never assigned in the reference
    # (BGC_parms.F90:206): the host reads zeros, and so do we
    assert (np.asarray(out.diags["POC_ACCUM"]) == 0.0).all()
    # saturation depths: the crossing interpolation divides by a CO3
    # anomaly difference, amplifying the ~solver-tolerance CO3 error for
    # near-grazing crossings -> mm-level agreement, not exact
    np.testing.assert_allclose(np.asarray(out.diags["zsatcalc"]),
                               want_diags["zsatcalc"], rtol=2e-3, atol=1.0)
    np.testing.assert_allclose(np.asarray(out.diags["zsatarag"]),
                               want_diags["zsatarag"], rtol=2e-3, atol=1.0)


def test_bgc_conservation(rng):
    """The Jint closure diagnostics vanish: the source/sink only moves
    mass between pools (SURVEY.md par.4 property test)."""
    trc, grid, forcing, params, ph_prev, ph_alt = make_inputs(
        rng, nlev=10, ncol=8)
    out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                          jnp.asarray(ph_prev), jnp.asarray(ph_alt), params)
    scale = float(np.asarray(out.diags["photoC_TOT_zint"]).max()) + 1e-30
    for name in ("Jint_Ctot", "Jint_Ntot", "Jint_Ptot", "Jint_Sitot"):
        resid = np.abs(np.asarray(out.diags[name]))
        assert (resid < 1e-10 * scale + 1e-18).all(), (
            f"{name} residual {resid.max()} vs scale {scale}")


def test_bgc_land_and_padding(rng):
    trc, grid, forcing, params, ph_prev, ph_alt = make_inputs(rng)
    out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                          jnp.asarray(ph_prev), jnp.asarray(ph_alt), params)
    tend = np.asarray(out.tendencies)
    kmax = np.asarray(grid.kmax)
    assert (tend[:, :, 1] == 0.0).all()           # land column
    for col in range(tend.shape[2]):
        assert (tend[kmax[col]:, :, col] == 0.0).all()
    assert np.isfinite(tend).all()
    # inactive cells keep their incoming pH state
    ph_out = np.asarray(out.ph_prev_3d)
    for col in range(tend.shape[2]):
        np.testing.assert_array_equal(ph_out[kmax[col]:, col],
                                      ph_prev[kmax[col]:, col])


def test_level_scan_unroll_ulp_equivalent(rng, monkeypatch):
    """Partial unrolling of the level scan is a scheduling choice: the
    recurrence order is unchanged, but XLA may re-fuse/contract ops per
    unrolled body, so results agree to a few ulps (measured max 4e-15
    relative), not bitwise.  The accuracy contract (allclose vs oracle)
    is unaffected; this pins the deviation at the ulp level."""
    import ocean_bgc.ops.bgc as bgc_mod

    trc, grid, forcing, params, ph_prev, ph_alt = make_inputs(rng)
    outs = []
    for unroll in (1, 4, 7):
        monkeypatch.setattr(bgc_mod, "_LEVEL_SCAN_UNROLL", unroll)
        out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                              jnp.asarray(ph_prev), jnp.asarray(ph_alt),
                              params, compute_diags=False)
        outs.append(np.asarray(out.tendencies))
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], rtol=1e-13, atol=1e-19)


def test_nitrif_taper_extreme_par_out(rng):
    """Pin the euphotic-zone nitrification taper in the extreme-but-
    representable regime the 1e-37 log floor was added around
    (ops/bgc.py ~:873, ADVICE round 3): a single cell of optical depth
    ~74 puts par_out near 1e-30 — far below any physical value yet
    comfortably above the float32 flush threshold (~1e-38) — and the
    floored CPU forward must still match the floor-free oracle formula
    (BGC_mod.F90:1552-1560) through the PAR-path tolerance."""
    import math

    from tests.oracle.bgc_ref import F_QSW_PAR, _par_cell

    trc, grid, forcing, params, ph_prev, ph_alt = make_inputs(
        rng, nlev=4, ncol=6)
    trc = trc.copy()
    nh4 = 0.7
    trc[0, T.NH4, :] = nh4
    # column 0, level 0: huge chlorophyll * thickness -> kpar_dz ~ 74
    trc[0, T.SPCHL, 0] = 10.0
    for g in range(1, 4):
        trc[0, T.CHL_IND[g], 0] = 0.0
    dz = np.full((4, 6), 400.0)
    dz[0, 0] = 22890.0
    zbot = np.cumsum(dz, axis=0)
    grid = ColumnGrid(
        cell_center_depth=jnp.asarray(zbot - 0.5 * dz),
        cell_thickness=jnp.asarray(dz),
        cell_bottom_depth=jnp.asarray(zbot),
        latitude=grid.latitude,
        kmax=jnp.asarray(np.ones(6, np.int32)),  # only k=0 active
    )
    import dataclasses
    forcing = dataclasses.replace(
        forcing, shortwave_surface=jnp.asarray(np.full(6, 300.0)))

    # the directed world really is in the extreme regime (oracle math)
    par_in = 300.0 * F_QSW_PAR
    par_out, _, kpar_dz = _par_cell(par_in, 10.0, 22890.0)
    assert 1e-37 < par_out < 1e-25, par_out
    assert par_in > params.parm_nitrif_par_lim > par_out

    out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                          jnp.asarray(ph_prev), jnp.asarray(ph_alt),
                          params)
    got = float(np.asarray(out.diags["NITRIF"])[0, 0])
    want = (params.parm_kappa_nitrif * nh4
            * math.log(par_out / params.parm_nitrif_par_lim)
            / (-kpar_dz))
    # taper engaged, reduces but does not kill nitrification
    assert 0.0 < got < params.parm_kappa_nitrif * nh4
    # CPU forward with the 1e-37 floor == floor-free formula (the floor
    # is an exact no-op for any representable par_out >= 1e-37); the
    # tolerance is the kernel-vs-oracle PAR-path ULP envelope, same as
    # test_bgc_matches_oracle
    np.testing.assert_allclose(got, want, rtol=1e-9)
