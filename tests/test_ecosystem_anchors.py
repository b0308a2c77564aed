"""Independent anchors for the ecosystem kinetics (VERDICT round-2 #6).

The trajectory gates compare the JAX kernel against a same-author scalar
oracle, so a shared misreading of the reference would pass them.  This
module pins the ecosystem against *externally known* outcomes instead:

* directed worlds with analytically forced results (dark ocean, barren
  ocean, single-autotroph oceans, exact Michaelis-Menten half-saturation
  points), and
* published stoichiometric/kinetic values asserted the way
  test_literature_anchors.py does for the carbonate chemistry:
  - Monod/Michaelis-Menten nutrient limitation (Moore et al. 2002,
    Deep-Sea Res. II 49, eq. set in Table 2; textbook form),
  - the Q10 = 1.5 temperature law referenced to Tref = 30 degC
    (Doney, Glover & Najjar 1996, Deep-Sea Res. II 43; the reference
    declares exactly these, BGC_parms.F90:461-463),
  - photosynthesis O2:C stoichiometry 170:117 for NO3-fueled (new)
    production and 138:117 for NH4-fueled (regenerated) production
    (Anderson & Sarmiento 1994, GBC 8, P:N:C:-O2 = 1:16:117:170), the
    two linked by the 2 mol O2 / mol N nitrification debt
    (NH4+ + 2 O2 -> NO3- + H2O + 2 H+), which is also why the kernel
    charges 2*NITRIF of O2 consumption (BGC_mod.F90:1786-1788).

Every check runs through the full public kernel (bgc_source_sink), not
formula internals.
"""

import dataclasses

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.constants import DPS
from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

SP, DIAT, DIAZ, PHAEO = 0, 1, 2, 3
GROUP_C = {SP: T.SPC, DIAT: T.DIATC, DIAZ: T.DIAZC, PHAEO: T.PHAEOC}
GROUP_CHL = {SP: T.SPCHL, DIAT: T.DIATCHL, DIAZ: T.DIAZCHL,
             PHAEO: T.PHAEOCHL}
GROUP_FE = {SP: T.SPFE, DIAT: T.DIATFE, DIAZ: T.DIAZFE, PHAEO: T.PHAEOFE}


def _world(nlev=4, ncol=4, seed=21):
    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol,
                                           seed=seed, ragged=False)
    return state, grid, forcing


def _eval(state, grid, forcing, params):
    return bgc_source_sink(state.bgc.tracers, grid, forcing,
                           state.bgc.ph_prev_3d,
                           state.bgc.ph_prev_alt_3d, params.bgc,
                           compute_diags=True)


def _set_tracers(state, fn):
    trc = np.asarray(state.bgc.tracers).copy()
    fn(trc)
    return dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc,
                                       tracers=jnp.asarray(trc)))


def _saturate_nutrients(trc):
    """Nutrient concentrations >> every half-saturation constant, so
    f_nut -> 1 to a few 1e-4 (kFe/Fe = 4e-4 is the slowest)."""
    trc[:, T.NO3] = 500.0
    trc[:, T.NH4] = 0.0
    trc[:, T.PO4] = 100.0
    trc[:, T.DOP] = 0.0
    trc[:, T.SIO3] = 500.0
    trc[:, T.FE] = 0.1


def test_dark_world_no_photosynthesis_nitrification_untapered():
    """No light => photoC and light_lim exactly zero for every group,
    and nitrification runs UNTAPERED at kappa_nitrif * NH4 everywhere
    (the PAR taper never engages: BGC_mod.F90:1554-1561)."""
    state, grid, forcing = _world()
    params = ModelParams()
    forcing = dataclasses.replace(
        forcing, shortwave_surface=jnp.zeros_like(
            forcing.shortwave_surface))
    state = _set_tracers(state, lambda trc: trc.__setitem__(
        (slice(None), T.NH4), 0.3))

    out = _eval(state, grid, forcing, params)
    np.testing.assert_array_equal(np.asarray(out.diags["photoC"]), 0.0)
    np.testing.assert_array_equal(np.asarray(out.diags["light_lim"]),
                                  0.0)
    want = params.bgc.parm_kappa_nitrif * 0.3
    np.testing.assert_allclose(np.asarray(out.diags["NITRIF"]), want,
                               rtol=1e-15)


def test_barren_world_uptake_zero_losses_proceed():
    """Zero nutrients => every uptake channel is exactly zero (photoC,
    N/P/Fe/Si uptake), while mortality, aggregation and grazing of the
    standing biomass continue (BGC_mod.F90:1285-1324 do not depend on
    nutrient state)."""
    state, grid, forcing = _world()
    params = ModelParams()

    def barren(trc):
        for idx in (T.NO3, T.NH4, T.PO4, T.DOP, T.SIO3, T.FE):
            trc[:, idx] = 0.0
        # healthy standing stocks, internally consistent pools
        for g in range(4):
            trc[:, GROUP_C[g]] = 1.0
            trc[:, GROUP_CHL[g]] = 0.25
            trc[:, GROUP_FE[g]] = 4e-6
        trc[:, T.DIATSI] = 0.15
        trc[:, T.SPCACO3] = 0.05
        trc[:, T.ZOOC] = 1.0

    state = _set_tracers(state, barren)
    out = _eval(state, grid, forcing, params)
    d = out.diags
    for name in ("photoC", "photoNO3", "photoNH4", "PO4_uptake",
                 "DOP_uptake", "photoFe", "bSi_form"):
        np.testing.assert_array_equal(np.asarray(d[name]), 0.0,
                                      err_msg=name)
    # losses proceed: every group is grazed and suffers mortality
    graze = np.asarray(d["auto_graze"])   # (nlev, nauto, ncol)
    loss = np.asarray(d["auto_loss"])
    assert (graze > 0.0).all(), "grazing halted in a barren ocean"
    assert (loss > 0.0).all(), "mortality halted in a barren ocean"


def test_monod_half_saturation_anchor():
    """Michaelis-Menten/Monod anchor (Moore et al. 2002): with NH4 = 0
    and NO3 set EXACTLY to a group's half-saturation constant, that
    group's N limitation term is exactly
    (NO3/kNO3)/(1 + NO3/kNO3) = 1/2; for diatoms at the same NO3,
    (0.1/0.5)/(1 + 0.1/0.5) = 1/6."""
    state, grid, forcing = _world()
    params = ModelParams()
    sp = params.bgc.autotrophs[SP]
    assert sp.kNO3 == 0.1   # BGC_parms.F90:556 (needed below)

    def half_sat(trc):
        _saturate_nutrients(trc)
        trc[:, T.NO3] = sp.kNO3

    state = _set_tracers(state, half_sat)
    out = _eval(state, grid, forcing, params)
    n_lim = np.asarray(out.diags["N_lim"])    # (nlev, nauto, ncol)
    np.testing.assert_allclose(n_lim[:, SP], 0.5, rtol=1e-14)
    diat = params.bgc.autotrophs[DIAT]
    r = sp.kNO3 / diat.kNO3
    np.testing.assert_allclose(n_lim[:, DIAT], r / (1.0 + r),
                               rtol=1e-14)
    # diazotrophs are N-fixers: never N-limited (vnt == 1)
    np.testing.assert_array_equal(n_lim[:, DIAZ], 1.0)


def test_q10_temperature_law_and_saturated_growth():
    """Temperature anchor (Doney et al. 1996; BGC_parms.F90:461-463):
    at light+nutrient saturation the C-specific growth rate equals
    PCref * Q10^((T-30)/10).  At T = Tref = 30 degC the measured
    photoC/spC is PCref itself (5.5 / day, BGC_parms.F90:560) to the
    saturation residual; cooling 10 degC divides it by exactly
    Q10 = 1.5."""
    params = ModelParams()
    sp = params.bgc.autotrophs[SP]

    def configure(state, forcing, temp_c):
        forcing = dataclasses.replace(
            forcing,
            shortwave_surface=jnp.full_like(forcing.shortwave_surface,
                                            2000.0),
            potential_temperature=jnp.full_like(
                forcing.potential_temperature, temp_c))

        def fix(trc):
            _saturate_nutrients(trc)
            trc[:, T.SPC] = 1.0
            trc[:, T.SPCHL] = 0.25
            trc[:, T.SPFE] = 4e-6
            trc[:, T.SPCACO3] = 0.05

        return _set_tracers(state, fix), forcing

    state, grid, forcing0 = _world()
    s30, f30 = configure(state, forcing0, 30.0)
    s20, f20 = configure(state, forcing0, 20.0)
    rate30 = (np.asarray(_eval(s30, grid, f30, params).diags["photoC"])
              [0, SP, :])          # surface cells: saturating PAR
    rate20 = (np.asarray(_eval(s20, grid, f20, params).diags["photoC"])
              [0, SP, :])
    # photoC/spC at Tref == PCref (5.5/day), saturation residual ~4e-4
    np.testing.assert_allclose(rate30, sp.PCref, rtol=2e-3)
    assert abs(sp.PCref / DPS - 5.5) < 1e-12
    # Q10 law: exactly a factor 1.5 per 10 degC (saturated light both)
    np.testing.assert_allclose(rate30 / rate20, 1.5, rtol=1e-6)


def test_o2_production_stoichiometry_anchors():
    """O2:C photosynthesis quotients (Anderson & Sarmiento 1994,
    P:N:C:-O2 = 1:16:117:170): NO3-fueled production makes 170/117 mol
    O2 per mol C; NH4-fueled production makes (170-2*16)/117 = 138/117
    — the deficit is the 2 mol O2 / mol N the nitrifiers already spent
    (which the kernel separately charges as 2*NITRIF of consumption,
    BGC_mod.F90:1786-1788).  Diazotrophs are zeroed so the two pure
    regimes are exact."""
    from ocean_bgc import constants as c
    params = ModelParams()
    red = c.PARM_RED_D_C_O2                 # 117/170
    remin = c.PARM_REMIN_D_C_O2             # 117/138
    # the nitrification identity links the two published quotients
    np.testing.assert_allclose(1.0 / red - 1.0 / remin,
                               2.0 * 16.0 / 117.0, rtol=1e-12)

    def pure_regime(no3, nh4):
        state, grid, forcing = _world(seed=33)

        def fix(trc):
            _saturate_nutrients(trc)
            trc[:, T.NO3] = no3
            trc[:, T.NH4] = nh4
            trc[:, T.DIAZC] = 0.0
            trc[:, T.DIAZCHL] = 0.0
            trc[:, T.DIAZFE] = 0.0

        state = _set_tracers(state, fix)
        out = _eval(state, grid, forcing, params)
        o2p = np.asarray(out.diags["O2_PRODUCTION"])
        pc = np.asarray(out.diags["photoC_TOT"])
        m = pc > 0.0
        assert m.any()
        return o2p[m] / pc[m]

    np.testing.assert_allclose(pure_regime(500.0, 0.0), 170.0 / 117.0,
                               rtol=1e-12)
    np.testing.assert_allclose(pure_regime(0.0, 500.0), 138.0 / 117.0,
                               rtol=1e-12)


def test_single_autotroph_worlds_sign_structure():
    """One group alive at a time: only it photosynthesizes, only the
    diazotroph fixes nitrogen (in warm N-starved water — fixation is
    the uptake shortfall, so it vanishes when NO3 saturates;
    temp_thres = 14 degC),
    only the diatom forms opal, and the dead groups' tracer tendencies
    are exactly zero."""
    params = ModelParams()
    for g in range(4):
        state, grid, forcing = _world(seed=40 + g)
        # phaeocystis uses the quasi-MMRT window (max 10 degC in the
        # southern hemisphere, 35 degC in the northern,
        # BGC_parms.F90:679-683): run its world at 5 degC so it grows
        # in BOTH hemispheres; everyone else at 25 degC (diaz needs
        # temp_thres = 14 degC)
        t_c = 5.0 if g == PHAEO else 25.0
        forcing = dataclasses.replace(
            forcing,
            potential_temperature=jnp.full_like(
                forcing.potential_temperature, t_c),
            shortwave_surface=jnp.full_like(forcing.shortwave_surface,
                                            300.0))

        def lone(trc, g=g):
            _saturate_nutrients(trc)
            trc[:, T.NH4] = 1.0
            if g == DIAZ:
                # fixation only covers the N demand the dissolved pools
                # cannot: starve NO3/NH4 so the fixer must fix
                trc[:, T.NO3] = 0.0
                trc[:, T.NH4] = 0.0
            trc[:, T.ZOOC] = 0.5
            for h in range(4):
                alive = 1.0 if h == g else 0.0
                trc[:, GROUP_C[h]] = alive
                trc[:, GROUP_CHL[h]] = 0.25 * alive
                trc[:, GROUP_FE[h]] = 4e-6 * alive
            trc[:, T.DIATSI] = 0.15 if g == DIAT else 0.0
            trc[:, T.SPCACO3] = 0.05 if g == SP else 0.0

        state = _set_tracers(state, lone)
        out = _eval(state, grid, forcing, params)
        photo = np.asarray(out.diags["photoC"])
        assert (photo[0, g] > 0.0).all(), f"group {g} did not grow"
        for h in range(4):
            if h != g:
                np.testing.assert_array_equal(photo[:, h], 0.0)
                np.testing.assert_array_equal(
                    np.asarray(out.tendencies[:, GROUP_C[h]]), 0.0)
        nfix = np.asarray(out.diags["Nfix"])
        if g == DIAZ:
            assert (nfix[0, DIAZ] > 0.0).all()
        else:
            np.testing.assert_array_equal(nfix, 0.0)
        bsi = np.asarray(out.diags["bSi_form"])
        if g == DIAT:
            assert (bsi[0, DIAT] > 0.0).all()
        else:
            np.testing.assert_array_equal(bsi, 0.0)


def test_phaeo_mmrt_hemisphere_window():
    """The quasi-MMRT latitude-hemisphere branch
    (BGC_mod.F90:1161-1177 with BGC_parms.F90:679-683): at 25 degC,
    phaeocystis grows in northern-hemisphere columns (max 35 degC) but
    is shut off in southern ones (max 10 degC)."""
    params = ModelParams()
    state, grid, forcing = _world(seed=44)
    lat = np.asarray(grid.latitude)
    assert (lat > 0).any() and (lat < 0).any()
    forcing = dataclasses.replace(
        forcing,
        potential_temperature=jnp.full_like(
            forcing.potential_temperature, 25.0),
        shortwave_surface=jnp.full_like(forcing.shortwave_surface,
                                        300.0))

    def lone_phaeo(trc):
        _saturate_nutrients(trc)
        for h in range(4):
            alive = 1.0 if h == PHAEO else 0.0
            trc[:, GROUP_C[h]] = alive
            trc[:, GROUP_CHL[h]] = 0.25 * alive
            trc[:, GROUP_FE[h]] = 4e-6 * alive
        trc[:, T.DIATSI] = 0.0
        trc[:, T.SPCACO3] = 0.0

    state = _set_tracers(state, lone_phaeo)
    out = _eval(state, grid, forcing, params)
    photo = np.asarray(out.diags["photoC"])[0, PHAEO]   # surface row
    assert (photo[lat > 0] > 0.0).all(), "phaeo shut off in the north"
    np.testing.assert_array_equal(photo[lat < 0], 0.0)


def test_grazing_loss_routing_closures():
    """Routing-budget closures hand-derived from the REFERENCE TEXT
    (BGC_mod.F90:1354-1372 routing, :1404-1415 zoo routing, :1421-1430
    DOM production, :1466-1467 POC production, :1729-1739 DIC assembly;
    fractions from BGC_parms.F90:576-580/615-619/654-658/693-697,
    parm_labile_ratio=0.85 :531, caco3_poc_min=0.4/spc_poc_fac=0.11/
    f_graze_sp_poc_lim=0.3 :395-399, f_graze_CaCO3_remin=0.33 :402,
    epsC=1e-8/epsTinv=3.17e-8 :480-481) — NOT from the kernel or the
    oracle, which share an author (VERDICT round 3 #8).  The grazing /
    mortality / aggregation RATES come from the kernel's own emitted
    diagnostics; only the ROUTING of those rates is hand-asserted:

      graze:  zoo 0.3 | poc trait (sp: max(0.4*QCaCO3,
              min(0.11*max(1, Pprime), 0.3))) | doc 0.15 | dic rest
      loss:   poc trait (sp: QCaCO3) | remainder split 0.15 DOC / 0.85
              DIC (labile ratio)
      zoo:    f_zoo_detr (graze-weighted 0.15/0.2/0.15/0.2) to POC;
              remainder split 0.15 DOC / 0.85 DIC
      P:      diaz (Qp=0.002735 != 0.00855) re-routes its excess P,
              0.15 of it to DOP

    in a directed dark, nutrient-free, DOM-free shallow world where
    every other DIC/DOC/POC source is structurally zero.
    """
    state, grid, forcing = _world(nlev=1, ncol=4, seed=33)
    params = ModelParams()
    forcing = dataclasses.replace(
        forcing,
        shortwave_surface=jnp.zeros_like(forcing.shortwave_surface),
        dust_flux_in=jnp.zeros_like(forcing.dust_flux_in),
        nutr_restore_rtau=jnp.zeros_like(forcing.nutr_restore_rtau),
        potential_temperature=jnp.full_like(
            forcing.potential_temperature, 20.0),
    )
    # shallow cell (50 m < thres_z1 = 100 m): f_loss_thres = 1 exactly
    dz = np.full((1, 4), 5000.0)          # cm
    grid = dataclasses.replace(
        grid,
        cell_thickness=jnp.asarray(dz),
        cell_bottom_depth=jnp.asarray(np.cumsum(dz, axis=0)),
        cell_center_depth=jnp.asarray(np.cumsum(dz, axis=0) - 0.5 * dz),
        kmax=jnp.asarray(np.ones(4, np.int32)),
    )

    spc, spcaco3, zooc = 1.0, 0.05, 0.5

    def directed(trc):
        trc[:] = 0.0
        trc[:, T.DIC] = 2000.0
        trc[:, T.DIC_ALT_CO2] = 2000.0
        trc[:, T.ALK] = 2300.0
        trc[:, T.O2] = 300.0              # oxic: no denitrif
        for g in range(4):
            trc[:, GROUP_C[g]] = 1.0
            trc[:, GROUP_CHL[g]] = 0.25
            trc[:, GROUP_FE[g]] = 4e-6
        trc[:, T.SPC] = spc
        trc[:, T.SPCACO3] = spcaco3
        trc[:, T.DIATSI] = 0.15
        trc[:, T.ZOOC] = zooc

    state = _set_tracers(state, directed)
    out = _eval(state, grid, forcing, params)
    d = {k: np.asarray(v) for k, v in out.diags.items()}
    tend = np.asarray(out.tendencies)

    graze = d["auto_graze"][0]            # (nauto, ncol)
    loss = d["auto_loss"][0]
    agg = d["auto_agg"][0]
    zoo_loss = d["zoo_loss"][0]
    assert (graze > 0).all() and (loss > 0).all() and (zoo_loss > 0).all()

    labile = 0.85                         # BGC_parms.F90:531
    # QCaCO3 carries the reference's own epsC guard in the denominator
    # (BGC_mod.F90:894-896); < QCaCO3_max = 0.4
    qcaco3 = spcaco3 / (spc + 1.0e-8)
    # sp grazing POC fraction: Pprime = spC - 1*loss_thres = 0.96, so
    # min(0.11*max(1, 0.96), 0.3) = 0.11 > 0.4*QCaCO3 = 0.02
    sp_poc_frac = max(0.4 * qcaco3, min(0.11 * max(1.0, spc - 0.04), 0.3))
    assert sp_poc_frac == 0.11
    graze_poc_frac = np.array([sp_poc_frac, 0.42, 0.05, 0.42])
    graze_zoo_frac = np.array([0.3, 0.3, 0.3, 0.3])
    graze_doc_frac = np.array([0.15, 0.15, 0.15, 0.15])
    loss_poc_frac = np.array([qcaco3, 0.0, 0.0, 0.0])
    f_zoo_detr_g = np.array([0.15, 0.2, 0.15, 0.2])

    graze_zoo = graze_zoo_frac[:, None] * graze
    graze_poc = graze_poc_frac[:, None] * graze
    graze_doc = graze_doc_frac[:, None] * graze
    graze_dic = graze - graze_zoo - graze_poc - graze_doc
    loss_poc = loss_poc_frac[:, None] * loss
    loss_doc = (1 - labile) * (loss - loss_poc)
    loss_dic = labile * (loss - loss_poc)

    w = graze + 1.0e-8 * 3.17e-8          # epsC * epsTinv
    f_zoo_detr = (f_zoo_detr_g[:, None] * w).sum(0) / w.sum(0)
    zoo_loss_doc = (1 - labile) * (1 - f_zoo_detr) * zoo_loss
    zoo_loss_dic = labile * (1 - f_zoo_detr) * zoo_loss

    # 1) zooplankton gains exactly the graze_zoo share
    # tendencies are small differences of larger routed terms, so ULP
    # noise in the inputs is cancellation-amplified -> 1e-9 envelope
    np.testing.assert_allclose(tend[0, T.ZOOC],
                               graze_zoo.sum(0) - zoo_loss, rtol=1e-12,
                               atol=1e-20)
    # 2) POC production = routed grazing + all aggregation + routed
    #    mortality + detrital zoo share (BGC_mod.F90:1466-1467)
    np.testing.assert_allclose(
        d["POC_PROD"][0],
        graze_poc.sum(0) + agg.sum(0) + loss_poc.sum(0)
        + f_zoo_detr * zoo_loss, rtol=1e-13)
    # 3) DOC production (BGC_mod.F90:1421) and the DOC tendency (no
    #    remin: DOC == 0)
    np.testing.assert_allclose(
        d["DOC_prod"][0],
        graze_doc.sum(0) + loss_doc.sum(0) + zoo_loss_doc, rtol=1e-13)
    np.testing.assert_allclose(tend[0, T.DOC], d["DOC_prod"][0],
                               rtol=1e-13)
    # 4) DIC receives every remainder plus in-cell remineralization and
    #    the 33% grazed-CaCO3 dissolution (BGC_mod.F90:1729-1739); dark
    #    => photoC = CaCO3_PROD = 0, DOM-free => DOC_remin = 0
    np.testing.assert_array_equal(d["photoC_TOT"][0], 0.0)
    # CaCO3 FORMATION (the DIC-assembly term CaCO3_PROD(auto_ind),
    # proportional to photoC) is zero in the dark; the separately-named
    # particulate-production diag CaCO3_PROD = P_CaCO3%prod is NOT
    np.testing.assert_array_equal(d["tot_CaCO3_form"][0], 0.0)
    np.testing.assert_allclose(
        tend[0, T.DIC],
        graze_dic.sum(0) + loss_dic.sum(0) + zoo_loss_dic
        + d["POC_REMIN"][0] + d["CaCO3_REMIN"][0]
        + 0.33 * graze[0] * qcaco3, rtol=1e-12, atol=1e-20)
    # 5) total carbon closure of the routing split itself
    np.testing.assert_allclose(
        (graze_zoo + graze_poc + graze_doc + graze_dic).sum(0),
        graze.sum(0), rtol=1e-14)
    np.testing.assert_allclose(
        (loss_poc + loss_doc + loss_dic).sum(0), loss.sum(0), rtol=1e-14)
    # 6) variable-Qp re-routing (diaz Qp = 0.002735 != Qp_zoo_pom =
    #    0.00855, BGC_parms.F90:634/422; BGC_mod.F90:1380-1386 and the
    #    DOP_prod assembly :1423-1430)
    qp_zoo, qp = 0.00855, np.array([0.00855, 0.00855, 0.002735, 0.00855])
    dop_prod = qp_zoo * zoo_loss_doc
    for g in range(4):
        if qp[g] == qp_zoo:
            dop_prod = dop_prod + qp[g] * (loss_doc[g] + graze_doc[g])
        else:
            remaining_p = ((graze[g] + loss[g] + agg[g]) * qp[g]
                           - graze_zoo[g] * qp_zoo
                           - (graze_poc[g] + loss_poc[g] + agg[g])
                           * qp_zoo)
            dop_prod = dop_prod + (1 - labile) * remaining_p
    np.testing.assert_allclose(d["DOP_prod"][0], dop_prod, rtol=1e-13)
    # 7) nitrogen and iron DOM production track the carbon routing with
    #    fixed stoichiometry (BGC_mod.F90:1422 DON_prod = Q*DOC_prod
    #    with Q = 0.137, BGC_parms.F90:421; :1431-1434 DOFe_prod =
    #    Qfe_zoo*zoo_loss_doc + sum Qfe_g*(loss_doc_g + graze_doc_g),
    #    Qfe_zoo = 3.0e-6 :423, Qfe_g the dynamic quota
    #    autotrophFe/(autotrophC + epsC) :852 = 4e-6/(1 + 1e-8) here)
    np.testing.assert_allclose(d["DON_prod"][0],
                               0.137 * d["DOC_prod"][0], rtol=1e-14)
    qfe_g = 4e-6 / (1.0 + 1.0e-8)
    dofe_prod = (3.0e-6 * zoo_loss_doc
                 + qfe_g * (loss_doc + graze_doc).sum(0))
    np.testing.assert_allclose(d["DOFe_prod"][0], dofe_prod, rtol=1e-13)
