"""Independent literature check values for every physical-chemistry fit.

Round-1's correctness gates all compared against a same-author NumPy
oracle — a shared misreading of a polynomial block would have passed
every test.  This module anchors each equilibrium constant / solubility /
Schmidt fit to a value published *outside this codebase*, at the standard
reference state, so a transcription error in any coefficient fails here
against a number that was never derived from this repo's own code.

Sources of the expected values (all standard, widely tabulated):

* Dickson, Sabine & Christian (2007), "Guide to best practices for ocean
  CO2 measurements", PICES Special Publication 3, chapter 5 check values
  at S = 35, t = 25 C (total hydrogen-ion scale where applicable):
  pK1 = 5.8472, pK2 = 8.9660 (Lueker et al. 2000), pKB = 8.5975
  (Dickson 1990b), pKW = 13.2173 (Millero 1995), KS = 0.1003 mol/kg
  (Dickson 1990a, free scale), pK1P = 1.61, pK2P = 5.96, pK3P = 8.79
  (DOE 1994 / Millero 1995), pKSi = 9.38 (Millero 1995).
* Weiss (1974) Table: K0(25 C, S=35) = 2.839e-2 mol kg-1 atm-1.
* Mucci (1983): Ksp(calcite)  = 10**-6.3693 = 4.272e-7 mol^2 kg^-2 and
  Ksp(aragonite) = 10**-6.1883 = 6.482e-7 at S = 35, t = 25 C.
* Uppstrom (1974): BT = 0.000232/10.811 * (S/1.80655) -> 415.8 umol/kg
  at S = 35; Morris & Riley (1966): ST = 0.02824 mol/kg; Riley (1965):
  FT = 68.3 umol/kg.
* Wanninkhof (1992) Table A1, CO2 in seawater: Sc(20 C) = 665.99
  (the polynomial value; 660 is the paper's rounded normalization).
* Keeling et al. (1998): Sc_O2(20 C) = 530.6.
* Saltzman et al. (1993): Sc_DMS(20 C) = 918.0 (exact polynomial value).
* Garcia & Gordon (1992) via the reference's embedded check value:
  O2SAT(10 C, 35 psu) = 282.015 mmol/m^3 (BGC_mod.F90:3028-3029).

Reference formula provenance: co2calc.F90:320-777 (equilibrium
constants), co2calc.F90:1096-1238 (Mucci solubilities),
BGC_mod.F90:2965-3128 (O2/CO2 Schmidt + O2SAT),
DMS_mod.F90:915-959 (DMS Schmidt).
"""

import math

import numpy as np

import ocean_bgc  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc.constants import MASS_TO_VOL
from ocean_bgc.ops.carbonate import carbonate_coeffs, co3_sat_vals
from ocean_bgc.ops.schmidt import (dmssat, o2sat, schmidt_co2,
                                   schmidt_dms, schmidt_o2)

T25 = jnp.asarray([25.0])
S35 = jnp.asarray([35.0])
SURF = jnp.zeros(1)


def _pk(value):
    return -math.log10(float(value[0]))


def test_equilibrium_constants_vs_best_practices_check_values():
    """pK's at S=35, t=25 C vs Dickson/Sabine/Christian (2007) table.

    Tolerance 5e-4 in pK: tight enough that any mistyped polynomial
    coefficient (which shifts pK by >= 1e-2) fails, loose enough to
    absorb last-digit rounding of the published values.
    """
    c = carbonate_coeffs(SURF, T25, S35, False, k1_k2_ph_tot=True)
    expected_pk = {
        "k1": 5.8472,     # Lueker et al. 2000, total scale
        "k2": 8.9660,     # Lueker et al. 2000, total scale
        "kb": 8.5975,     # Dickson 1990b
        "kw": 13.2173,    # Millero 1995 composite
        "ks": 0.9987,     # Dickson 1990a (KS = 0.1003 mol/kg, free scale)
        "k1p": 1.6119,    # DOE 1994 / Yao & Millero check value 1.61
        "k2p": 5.9618,    # check value 5.96
        "k3p": 8.7893,    # check value 8.79
        "ksi": 9.3838,    # check value 9.38
    }
    for name, want in expected_pk.items():
        got = _pk(getattr(c, name))
        assert abs(got - want) < 5e-4, f"p{name.upper()}: {got} != {want}"


def test_weiss_k0_and_total_concentrations():
    c = carbonate_coeffs(SURF, T25, S35, False)
    k0 = float(c.k0[0])
    assert abs(k0 - 2.839e-2) < 5e-5, k0       # Weiss 1974
    # total borate / sulfate / fluoride at S=35 (mol/kg)
    assert abs(float(c.bt[0]) - 415.8e-6) < 0.5e-6    # Uppstrom 1974
    assert abs(float(c.st[0]) - 0.02824) < 1e-5       # Morris & Riley 1966
    assert abs(float(c.ft[0]) - 68.3e-6) < 0.5e-6     # Riley 1965


def test_mucci_solubility_products():
    """Back out Ksp from the saturation [CO3=] and pin to Mucci 1983."""
    calc, arag = co3_sat_vals(SURF, T25, S35, False)
    ca = 0.01028                        # [Ca2+] mol/kg at S=35 (Culkin)
    ksp_calc = float(calc[0]) / MASS_TO_VOL * ca
    ksp_arag = float(arag[0]) / MASS_TO_VOL * ca
    assert abs(math.log10(ksp_calc) - (-6.3693)) < 1e-3
    assert abs(math.log10(ksp_arag) - (-6.1883)) < 1e-3


def test_schmidt_numbers_at_20C():
    t20 = jnp.asarray([20.0])
    assert abs(float(schmidt_co2(t20)[0]) - 665.99) < 0.05   # Wanninkhof 92
    assert abs(float(schmidt_o2(t20)[0]) - 530.6) < 0.1      # Keeling 98
    assert abs(float(schmidt_dms(t20)[0]) - 918.0) < 0.05    # Saltzman 93


def test_o2sat_embedded_check_value():
    got = float(o2sat(jnp.asarray([10.0]), S35)[0])
    assert abs(got - 282.015) < 5e-4, got       # BGC_mod.F90:3028-3029


def test_dms_saturation_is_zero():
    """DMSSAT == 0 by construction (DMS_mod.F90:1003: atmospheric DMS
    negligible) — pinned so a future edit can't silently break the
    one-way flux convention."""
    assert float(dmssat(jnp.asarray([15.0]), S35)[0]) == 0.0
