"""Schmidt numbers and gas saturation concentrations (elementwise).

Reference provenance: SCHMIDT_O2_singleValue (BGC_mod.F90:2965-3005, Keeling
et al. 1998), O2SAT_singleValue (BGC_mod.F90:3012-3083, Garcia & Gordon
1992 — check value T=10 C, S=35 psu -> 282.015 mmol/m^3),
SCHMIDT_CO2_singleValue (BGC_mod.F90:3091-3128, Wanninkhof 1992),
SCHMIDT_DMS_singleValue (DMS_mod.F90:915-959, Kettle & Andreae 2000),
DMSSAT_singleValue (DMS_mod.F90:966-1008, atmospheric DMS neglected).
"""

from __future__ import annotations

import jax.numpy as jnp

from ocean_bgc.constants import T0_KELVIN


def schmidt_o2(sst):
    """Schmidt number of O2 in seawater at SST (C)."""
    a, b, c, d = 1638.0, 81.83, 1.483, 0.008004
    return a + sst * (-b + sst * (c + sst * (-d)))


def schmidt_co2(sst):
    """Schmidt number of CO2 in seawater at SST (C)."""
    a, b, c, d = 2073.1, 125.62, 3.6276, 0.043219
    return a + sst * (-b + sst * (c + sst * (-d)))


def schmidt_dms(sst):
    """Schmidt number of DMS in seawater at SST (C)."""
    a, b, c, d = 2674.0, 147.12, 3.726, 0.038
    return a + sst * (-b + sst * (c + sst * (-d)))


def o2sat(sst, sss):
    """O2 saturation at 1 atm (mmol/m^3) from SST (C) and SSS (psu)."""
    a_0, a_1, a_2 = 2.00907, 3.22014, 4.05010
    a_3, a_4, a_5 = 4.94457, -2.56847e-1, 3.88767
    b_0, b_1, b_2, b_3 = -6.24523e-3, -7.37614e-3, -1.03410e-2, -8.17083e-3
    c_0 = -4.88682e-7

    ts = jnp.log(((T0_KELVIN + 25.0) - sst) / (T0_KELVIN + sst))
    o2sat_mll = jnp.exp(
        a_0 + ts * (a_1 + ts * (a_2 + ts * (a_3 + ts * (a_4 + ts * a_5))))
        + sss * ((b_0 + ts * (b_1 + ts * (b_2 + ts * b_3))) + sss * c_0))
    return o2sat_mll / 0.0223916  # ml/l -> mmol/m^3


def dmssat(sst, sss):
    """DMS saturation concentration: zero (atmospheric DMS negligible)."""
    return jnp.zeros_like(sst + sss)
