"""Parameter defaults and derived constants match the reference values."""

import numpy as np

import ocean_bgc  # noqa: F401
from ocean_bgc import constants as c
from ocean_bgc.params import (BGCParams, DMSParams, MACROSParams,
                              default_autotrophs)
from ocean_bgc.state import (BGC_TRACER_NAMES, BGCTracers,
                             bgc_tracer_units)


def test_time_conversions():
    assert c.SPD == 86400.0
    np.testing.assert_allclose(c.DPS * c.SPD, 1.0, rtol=1e-15)
    np.testing.assert_allclose(c.YPS * 365.0 * c.SPD, 1.0, rtol=1e-15)


def test_redfield_ratios():
    np.testing.assert_allclose(c.PARM_RED_D_C_N, 117.0 / 16.0, rtol=1e-15)
    np.testing.assert_allclose(c.PARM_RED_D_C_O2, 117.0 / 170.0, rtol=1e-15)
    np.testing.assert_allclose(c.PARM_REMIN_D_C_O2, 117.0 / 138.0, rtol=1e-15)
    np.testing.assert_allclose(c.PARM_RED_D_C_O2_DIAZ, 117.0 / 150.0,
                               rtol=1e-15)
    np.testing.assert_allclose(c.DENITRIF_C_N, 117.0 / 136.0, rtol=1e-15)
    np.testing.assert_allclose(c.DUST_TO_FE, 0.035 / 55.847 * 1e9, rtol=1e-15)


def test_autotroph_defaults():
    sp, diat, diaz, phaeo = default_autotrophs()
    assert sp.imp_calcifier and not diat.imp_calcifier
    assert diaz.nfixer and not sp.nfixer
    assert diat.has_si and not phaeo.has_si
    # phaeo is grazed with diatoms (BGC_parms.F90:666)
    assert phaeo.grazee_ind == diat.grazee_ind
    assert phaeo.temp_function == c.TFNC_QUASI_MMRT
    np.testing.assert_allclose(sp.PCref, 5.5 / 86400.0, rtol=1e-15)
    np.testing.assert_allclose(diaz.PCref, 0.7 / 86400.0, rtol=1e-15)
    np.testing.assert_allclose(phaeo.alphaPI, 0.77 / 86400.0, rtol=1e-15)
    np.testing.assert_allclose(diaz.Qp, 0.002735, rtol=1e-15)
    assert diat.kSiO3 == 0.8 and sp.kSiO3 == 0.0


def test_bgc_params_defaults():
    p = BGCParams()
    np.testing.assert_allclose(p.parm_kappa_nitrif, 0.06 / 86400.0, rtol=1e-15)
    np.testing.assert_allclose(p.parm_z_mort2_0, 0.4 / 86400.0, rtol=1e-15)
    assert p.parm_scalelen_vals == (1.0, 3.0, 5.0, 9.0)
    assert p.parm_POC_diss == 88.0e2
    assert p.locmip_k1_k2_bug_fix


def test_dms_macros_defaults():
    d = DMSParams()
    np.testing.assert_allclose(d.k_S_B, 30.0 / 86400.0, rtol=1e-15)
    assert d.Rs2n_phaeo == 0.3 and d.Rs2n_cyano == 0.0
    m = MACROSParams()
    assert m.f_prot + m.f_poly + m.f_lip == 1.0
    np.testing.assert_allclose(m.k_lip_bac, 1.0 / 86400.0, rtol=1e-15)


def test_tracer_registry():
    assert len(BGC_TRACER_NAMES) == BGCTracers.CNT == 30
    assert BGC_TRACER_NAMES[BGCTracers.DIC_ALT_CO2] == "DIC_ALT_CO2"
    units = bgc_tracer_units()
    assert units[BGCTracers.ALK] == "meq/m^3"
    assert units[BGCTracers.SPCHL] == "mg/m^3"
    assert units[BGCTracers.PO4] == "mmol/m^3"
    # autotroph cross-reference map is consistent
    assert BGCTracers.SI_IND[1] == BGCTracers.DIATSI
    assert BGCTracers.CACO3_IND[0] == BGCTracers.SPCACO3
    assert BGCTracers.SI_IND[0] is None and BGCTracers.CACO3_IND[1] is None
