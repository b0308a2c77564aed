"""Carbonate-system chemistry: equilibrium constants, total-alkalinity
root-find, speciation, and saturation states.

A re-design of the reference's ``co2calc`` module
(co2calc.F90:1-1242).  Every routine here is elementwise over arrays of any
shape — the batching that the reference reaches for with ``shr_vmath``
(co2calc.F90:12-15) is native: a whole column-batch of cells solves its pH
simultaneously, with the bracketed-Newton iteration
expressed as a masked ``lax.while_loop`` (each lane freezes when converged,
the loop exits when every lane has).

Provenance of each formula block is cited to co2calc.F90 line ranges; the
physical references (Weiss, Lueker, Millero, Dickson, Mucci, ...) are the
same ones the OCMIP2 code cites.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ocean_bgc.constants import (
    ALK_MIN,
    DIC_MIN,
    INV_R_GAS,
    MASS_TO_VOL,
    MAXIT,
    SALT_MIN,
    T0_KELVIN,
    VOL_TO_MASS,
    XACC,
)

import os

_LN10 = 2.302585092994045684   # ln(10)
# measurement knob: stack the interior ambient+ALT_CO2 dual solve at f64
# too (the production default keeps f64 sequential; see co3_terms_dual)
_DUAL_STACK_F64 = os.environ.get("OBGC_DUAL_STACK_F64", "0") == "1"
_LN_001 = -4.605170185988091368  # ln(1e-2)
# python-float constants (not jnp scalars): safe to close over inside
# the Pallas kernel (ops/pallas_carbonate.py)
_BRACKET_GROW_GUARD = 60   # geometric growth; reference loop is unbounded
                           # (abort commented out, co2calc.F90:931-933)


class CarbCoeffs(NamedTuple):
    """The 11 equilibrium constants + 3 total concentrations of
    comp_co3_coeffs (co2calc.F90:320-777), one value per cell."""

    k0: jax.Array
    k1: jax.Array
    k2: jax.Array
    ff: jax.Array      # CO2 fugacity factor
    kb: jax.Array
    k1p: jax.Array
    k2p: jax.Array
    k3p: jax.Array
    ksi: jax.Array
    kw: jax.Array
    ks: jax.Array
    kf: jax.Array
    bt: jax.Array      # total borate
    st: jax.Array      # total sulfate
    ft: jax.Array      # total fluoride


def press_bar_from_depth(depth_m):
    """POP reference pressure (bars) at depth (m) (co2calc.F90:156-157)."""
    return (0.059808 * (jnp.exp(-0.025 * depth_m) - 1.0)
            + 0.100766 * depth_m + 2.28405e-7 * depth_m ** 2)


def _pressure_ln_factor(deltaV, kappa, press_bar, invRtk):
    """(-dV + 0.5*kappa*P) * P / (R*T): the LOG of the Millero pressure
    correction factor.  Every constant it corrects is itself an exp(), so
    the correction is folded into that exp's argument — one transcendental
    instead of two (exp(a)*exp(c) -> exp(a+c), ~1 ulp; this removes 12
    of the ~38 exp/log per cell)."""
    return (-deltaV + 0.5 * kappa * press_bar) * press_bar * invRtk


def carbonate_coeffs(depth_m, temp, salt, apply_pressure, *,
                     k1_k2_ph_tot=True) -> CarbCoeffs:
    """All thermodynamic constants at (T, S, depth).

    ``apply_pressure`` is the vectorized form of the reference's ``k > 1``
    gate (pressure corrections only below the surface level,
    co2calc.F90:480-490 et seq.); it may be a Python bool or a traced
    scalar/array.  ``k1_k2_ph_tot`` selects Lueker-2000 total-scale k1/k2
    versus the legacy OCMIP2 seawater-scale fit (co2calc.F90:461-471).
    """
    press = press_bar_from_depth(depth_m)
    apply_pressure = jnp.asarray(apply_pressure)

    salt_lim = jnp.maximum(salt, SALT_MIN)
    tk = T0_KELVIN + temp
    tk100 = tk * 1e-2
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = jnp.log(tk)
    invRtk = INV_R_GAS * invtk

    ionic = 19.924 * salt_lim / (1000.0 - 1.005 * salt_lim)
    ionic2 = ionic * ionic
    sqrtis = jnp.sqrt(ionic)
    sqrts = jnp.sqrt(salt_lim)
    s2 = salt_lim * salt_lim
    scl = salt_lim / 1.80655
    log_1_m_1p005em3_s = jnp.log(1.0 - 0.001005 * salt_lim)

    def padd(deltaV, kappa):
        """Additive (log-space) Millero pressure correction, gated on
        the vectorized k > 1 test; exactly 0.0 at the surface so the
        uncorrected exp() is bit-identical to the ungated form."""
        ln_fac = _pressure_ln_factor(deltaV, kappa, press, invRtk)
        return jnp.where(apply_pressure, ln_fac, 0.0)

    # ff — Weiss & Price 1980 (co2calc.F90:423-431)
    ff = jnp.exp(-162.8301 + 218.2968 / tk100
                 + 90.9241 * (dlogtk + _LN_001) - 1.47696 * tk1002
                 + salt_lim * (0.025695 - 0.025225 * tk100
                               + 0.0049867 * tk1002))

    # k0 — Weiss 1974 (co2calc.F90:437-444)
    k0 = jnp.exp(93.4517 / tk100 - 60.2409
                 + 23.3585 * (dlogtk + _LN_001)
                 + salt_lim * (0.023517 - 0.023656 * tk100
                               + 0.0047036 * tk1002))

    # k1, k2 — Lueker 2000 (total) or Millero 1995 (seawater)
    # (co2calc.F90:461-519); pressure corr Millero 1995 p.675
    if k1_k2_ph_tot:
        arg1 = (3633.86 * invtk - 61.2172 + 9.67770 * dlogtk
                - 0.011555 * salt_lim + 0.0001152 * s2)
        arg2 = (471.78 * invtk + 25.9290 - 3.16967 * dlogtk
                - 0.01781 * salt_lim + 0.0001122 * s2)
    else:
        arg1 = (3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                - 0.0118 * salt_lim + 0.000116 * s2)
        arg2 = (1394.7 * invtk + 4.777 - 0.0184 * salt_lim + 0.000118 * s2)
    k1 = jnp.exp(-_LN10 * arg1
                 + padd(-25.5 + 0.1271 * temp, (-3.08 + 0.0877 * temp) * 1e-3))
    k2 = jnp.exp(-_LN10 * arg2
                 + padd(-15.82 - 0.0219 * temp, (1.13 - 0.1475 * temp) * 1e-3))

    # kb — Millero 1995 / Dickson 1990 (co2calc.F90:529-551)
    kb = jnp.exp((-8966.90 - 2890.53 * sqrts - 77.942 * salt_lim
                  + 1.728 * salt_lim * sqrts - 0.0996 * s2) * invtk
                 + (148.0248 + 137.1942 * sqrts + 1.62142 * salt_lim)
                 + (-24.4344 - 25.085 * sqrts - 0.2474 * salt_lim) * dlogtk
                 + 0.053105 * sqrts * tk
                 + padd(-29.48 + (0.1622 - 0.002608 * temp) * temp,
                        -2.84e-3))

    # k1p — DOE 1994 eq 7.2.20 (co2calc.F90:560-580)
    k1p = jnp.exp(-4576.752 * invtk + 115.525 - 18.453 * dlogtk
                  + (-106.736 * invtk + 0.69171) * sqrts
                  + (-0.65643 * invtk - 0.01844) * salt_lim
                  + padd(-14.51 + (0.1211 - 0.000321 * temp) * temp,
                         (-2.67 + 0.0427 * temp) * 1e-3))

    # k2p — DOE 1994 eq 7.2.23 (co2calc.F90:589-609)
    k2p = jnp.exp(-8814.715 * invtk + 172.0883 - 27.927 * dlogtk
                  + (-160.340 * invtk + 1.3566) * sqrts
                  + (0.37335 * invtk - 0.05778) * salt_lim
                  + padd(-23.12 + (0.1758 - 0.002647 * temp) * temp,
                         (-5.15 + 0.09 * temp) * 1e-3))

    # k3p — DOE 1994 eq 7.2.26 (co2calc.F90:618-637)
    k3p = jnp.exp(-3070.75 * invtk - 18.141
                  + (17.27039 * invtk + 2.81197) * sqrts
                  + (-44.99486 * invtk - 0.09984) * salt_lim
                  + padd(-26.57 + (0.202 - 0.003042 * temp) * temp,
                         (-4.08 + 0.0714 * temp) * 1e-3))

    # ksi — Millero 1995 / Yao & Millero (co2calc.F90:647-669);
    # pressure correction borrows the boric-acid values
    ksi = jnp.exp(-8904.2 * invtk + 117.385 - 19.334 * dlogtk
                  + (-458.79 * invtk + 3.5913) * sqrtis
                  + (188.74 * invtk - 1.5998) * ionic
                  + (-12.1652 * invtk + 0.07871) * ionic2
                  + log_1_m_1p005em3_s
                  + padd(-29.48 + (0.1622 - 0.002608 * temp) * temp,
                         -2.84e-3))

    # kw — Millero 1995 composite (co2calc.F90:681-700)
    kw = jnp.exp(-13847.26 * invtk + 148.9652 - 23.6521 * dlogtk
                 + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                 - 0.01615 * salt_lim
                 + padd(-20.02 + (0.1119 - 0.001409 * temp) * temp,
                        (-5.13 + 0.0794 * temp) * 1e-3))

    # ks — Dickson 1990, free scale (co2calc.F90:709-731)
    ks = jnp.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                 + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                 + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * ionic
                 - 2698.0 * invtk * ionic * sqrtis
                 + 1776.0 * invtk * ionic2
                 + log_1_m_1p005em3_s
                 + padd(-18.03 + (0.0466 + 0.000316 * temp) * temp,
                        (-4.53 + 0.09 * temp) * 1e-3))

    # kf — Dickson & Riley 1979, converted to total scale
    # (co2calc.F90:740-764); note dependence on ks computed above
    log_1_p_tot_sulfate_div_ks = jnp.log(
        1.0 + (0.1400 / 96.062) * scl / ks)
    kf = jnp.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                 + log_1_m_1p005em3_s + log_1_p_tot_sulfate_div_ks
                 + padd(-9.78 - (0.009 + 0.000942 * temp) * temp,
                        (-3.91 + 0.054 * temp) * 1e-3))

    # total borate (Uppstrom 1974), sulfate (Morris & Riley 1966),
    # fluoride (Riley 1965) (co2calc.F90:773-775)
    bt = 0.000232 / 10.811 * scl
    st = 0.14 / 96.062 * scl
    ft = 0.000067 / 18.9984 * scl

    return CarbCoeffs(k0=k0, k1=k1, k2=k2, ff=ff, kb=kb, k1p=k1p, k2p=k2p,
                      k3p=k3p, ksi=ksi, kw=kw, ks=ks, kf=kf,
                      bt=bt, st=st, ft=ft)


def talk(coeffs: CarbCoeffs, dic, ta, pt, sit, x):
    """Total alkalinity fn(H) and d(fn)/dH at htotal = x.

    Same 12-term TA residual as the reference's ``talk_row``
    (co2calc.F90:1001-1092), re-expressed by chemical species; every sum
    and product keeps the reference's association order (bitwise-pinned
    by tests/test_carbonate.py::test_talk_golden_bitwise), because
    factorization order is load-bearing for f64 trajectory parity.
    All concentrations in mol/kg.

    fn = hco3 + 2*co3 + borate + oh + hpo4 + 2*po4 + silicate
         - hfree - hso4 - hf - h3po4 - ta
    """
    h = x                               # total-scale [H+]
    inv_h = 1.0 / h
    h2 = h * h
    inv_h2 = inv_h * inv_h
    h3 = h2 * h
    k12 = coeffs.k1 * coeffs.k2         # carbonic K1*K2
    k12p = coeffs.k1p * coeffs.k2p      # phosphoric K1*K2
    k123p = k12p * coeffs.k3p           # phosphoric K1*K2*K3
    # phosphate speciation denominator h^3 + K1p h^2 + K1p K2p h + K1p K2p K3p
    phos_den = h3 + coeffs.k1p * h2 + k12p * h + k123p
    inv_phos_den = 1.0 / phos_den
    inv_phos_den2 = inv_phos_den * inv_phos_den
    dphos_den = 3.0 * h2 + 2.0 * coeffs.k1p * h + k12p
    # carbonate speciation denominator h^2 + K1 h + K1 K2
    carb_den = h2 + coeffs.k1 * h + k12
    inv_carb_den = 1.0 / carb_den
    inv_carb_den2 = inv_carb_den * inv_carb_den
    dcarb_den = 2.0 * h + coeffs.k1
    # total-to-free hydrogen scale conversion 1 + ST/KS
    htot_per_hfree = 1.0 + coeffs.st / coeffs.ks
    hfree_per_htot = 1.0 / htot_per_hfree
    inv_borate_den = 1.0 / (coeffs.kb + h)      # B(OH)4- denominator
    inv_sili_den = 1.0 / (coeffs.ksi + h)       # SiO(OH)3- denominator
    # HSO4- fraction of total sulfate: 1 / (1 + (1+ST/KS)*KS/H)
    hso4_frac = 1.0 / (1.0 + htot_per_hfree * coeffs.ks * inv_h)
    hf_frac = 1.0 / (1.0 + coeffs.kf * inv_h)   # HF fraction of fluoride

    fn = (coeffs.k1 * dic * h * inv_carb_den            # HCO3-
          + 2.0 * dic * k12 * inv_carb_den              # 2 CO3=
          + coeffs.bt * coeffs.kb * inv_borate_den      # B(OH)4-
          + coeffs.kw * inv_h                           # OH-
          + pt * k12p * h * inv_phos_den                # HPO4=
          + 2.0 * pt * k123p * inv_phos_den             # 2 PO4---
          + sit * coeffs.ksi * inv_sili_den             # SiO(OH)3-
          - h * hfree_per_htot                          # - free H+
          - coeffs.st * hso4_frac                       # - HSO4-
          - coeffs.ft * hf_frac                         # - HF
          - pt * h3 * inv_phos_den                      # - H3PO4
          - ta)

    df = (coeffs.k1 * dic * (carb_den - h * dcarb_den) * inv_carb_den2
          - 2.0 * dic * k12 * dcarb_den * inv_carb_den2
          - coeffs.bt * coeffs.kb * inv_borate_den * inv_borate_den
          - coeffs.kw * inv_h2
          + (pt * k12p * (phos_den - h * dphos_den)) * inv_phos_den2
          - 2.0 * pt * k123p * dphos_den * inv_phos_den2
          - sit * coeffs.ksi * inv_sili_den * inv_sili_den
          - 1.0 * hfree_per_htot
          - coeffs.st * hso4_frac * hso4_frac
            * (htot_per_hfree * coeffs.ks * inv_h2)
          - coeffs.ft * hf_frac * hf_frac * coeffs.kf * inv_h2
          - pt * h2 * (3.0 * phos_den - h * dphos_den) * inv_phos_den2)

    return fn, df


def _paired_reciprocal(a, b):
    """(1/a, 1/b) from ONE division: inv_ab = 1/(a*b), then
    1/a = b*inv_ab and 1/b = a*inv_ab.

    RANGE RULE: every intermediate stays inside float32's ~1e+/-38
    exponent range (CLAUDE.md, "Numerics").  A single combined
    reciprocal over all 8 TA denominators (product ~1e-65) would leave
    it.  Pairs are chosen so each product stays within [~1e-19, 1] at
    any bracket state the solver can reach."""
    inv_ab = 1.0 / (a * b)
    return b * inv_ab, a * inv_ab


def talk_fast(coeffs: CarbCoeffs, dic, ta, pt, sit, x):
    """The opt-in fast-f64 TA residual (OBGC_FAST_F64=1): the same 12
    chemical terms as :func:`talk` (co2calc.F90:1001-1092) with the
    reciprocals RE-ASSOCIATED — the 8 denominators inverted through 4
    divisions (:func:`_paired_reciprocal`; pairs sized for float32's
    exponent range — see that docstring), and
    the sulfate/fluoride/hydrogen-scale fractions rewritten
    division-free:

        HSO4 fraction   1/(1 + (1+ST/KS)*KS/H)  ==  H/(H + KS + ST)
        HF fraction     1/(1 + KF/H)            ==  H/(H + KF)
        free/total H+   1/(1 + ST/KS)           ==  KS/(KS + ST)

    Mathematically identical to talk(); floating-point results differ
    by reassociation ulps (~1e-15 relative), which perturbs the Newton
    iterate sequence within the solver tolerance.  NOT the bitwise f64
    contract path — qualified against it by tests/test_fast_f64.py
    with the same trajectory-envelope methodology as the fp32 path."""
    h = x
    h2 = h * h
    h3 = h2 * h
    k12 = coeffs.k1 * coeffs.k2
    k12p = coeffs.k1p * coeffs.k2p
    k123p = k12p * coeffs.k3p
    phos_den = h3 + coeffs.k1p * h2 + k12p * h + k123p
    dphos_den = 3.0 * h2 + 2.0 * coeffs.k1p * h + k12p
    carb_den = h2 + coeffs.k1 * h + k12
    dcarb_den = 2.0 * h + coeffs.k1
    borate_den = coeffs.kb + h
    sili_den = coeffs.ksi + h
    hso4_den = h + coeffs.ks + coeffs.st
    hf_den = h + coeffs.kf
    scale_den = coeffs.ks + coeffs.st

    # pair magnitudes (worst case over the solver's bracket range):
    # h (>=1e-11) * hso4_den (~0.06)      >= ~6e-13
    # phos_den (>=k1p*k2p*k3p ~1e-17) * scale_den (~0.07)  >= ~7e-19
    # carb_den (>=k1*k2 ~1.5e-15) * hf_den (>=kf ~2e-3)    >= ~3e-18
    # borate_den (>=kb ~2e-9) * sili_den (>=ksi ~4e-10)    >= ~8e-19
    # all inside float32's exponent range (~1e+/-38)
    inv_h, inv_hso4_den = _paired_reciprocal(h, hso4_den)
    inv_phos_den, inv_scale_den = _paired_reciprocal(phos_den, scale_den)
    inv_carb_den, inv_hf_den = _paired_reciprocal(carb_den, hf_den)
    inv_borate_den, inv_sili_den = _paired_reciprocal(borate_den,
                                                      sili_den)

    inv_h2 = inv_h * inv_h
    inv_phos_den2 = inv_phos_den * inv_phos_den
    inv_carb_den2 = inv_carb_den * inv_carb_den
    hfree_per_htot = coeffs.ks * inv_scale_den
    hso4_frac = h * inv_hso4_den
    hf_frac = h * inv_hf_den

    fn = (coeffs.k1 * dic * h * inv_carb_den            # HCO3-
          + 2.0 * dic * k12 * inv_carb_den              # 2 CO3=
          + coeffs.bt * coeffs.kb * inv_borate_den      # B(OH)4-
          + coeffs.kw * inv_h                           # OH-
          + pt * k12p * h * inv_phos_den                # HPO4=
          + 2.0 * pt * k123p * inv_phos_den             # 2 PO4---
          + sit * coeffs.ksi * inv_sili_den             # SiO(OH)3-
          - h * hfree_per_htot                          # - free H+
          - coeffs.st * hso4_frac                       # - HSO4-
          - coeffs.ft * hf_frac                         # - HF
          - pt * h3 * inv_phos_den                      # - H3PO4
          - ta)

    df = (coeffs.k1 * dic * (carb_den - h * dcarb_den) * inv_carb_den2
          - 2.0 * dic * k12 * dcarb_den * inv_carb_den2
          - coeffs.bt * coeffs.kb * inv_borate_den * inv_borate_den
          - coeffs.kw * inv_h2
          + (pt * k12p * (phos_den - h * dphos_den)) * inv_phos_den2
          - 2.0 * pt * k123p * dphos_den * inv_phos_den2
          - sit * coeffs.ksi * inv_sili_den * inv_sili_den
          - 1.0 * hfree_per_htot
          # (1+ST/KS)*KS == KS+ST, so the HSO4 slope needs no division
          - coeffs.st * hso4_frac * hso4_frac * scale_den * inv_h2
          - coeffs.ft * hf_frac * hf_frac * coeffs.kf * inv_h2
          - pt * h2 * (3.0 * phos_den - h * dphos_den) * inv_phos_den2)

    return fn, df


def x0_seed_enabled() -> bool:
    """OBGC_X0_SEED=1 opts into seeding the solver iteration at the
    previous step's root instead of the reference's bracket midpoint
    (read at trace time).  ~1 warm iteration instead of 2-3, BUT the
    returned root lands elsewhere inside the xacc tolerance ball (the
    midpoint-seeded root carries ~1e-4 relative error at the loose
    reference tolerance; the seeded one is closer to the true root but
    no longer matches the reference's iterate sequence), so like
    OBGC_FAST_F64 this is NOT the bitwise contract path — it is
    qualified by the same perturbation-envelope methodology
    (tests/test_carbonate.py, tests/test_fast_f64.py pattern) and
    ships opt-in."""
    return os.environ.get("OBGC_X0_SEED", "0") == "1"


def _fast_f64_enabled() -> bool:
    """OBGC_FAST_F64=1 opts the float64 solver into talk_fast (read at
    trace time; the flag never affects float32, whose solver already
    has its own qualified fast path)."""
    return os.environ.get("OBGC_FAST_F64", "0") == "1"


@jax.custom_vjp
def solve_htotal(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2):
    """Lane-parallel bracketed safe-Newton root-find for htotal
    (drtsafe_row, co2calc.F90:872-997).

    The reference solves one cell at a time; here every lane carries its own
    (bracket, Newton state, converged flag) and the ``while_loop`` runs until
    all lanes converge or MAXIT.  Per-lane update sequencing matches the
    scalar algorithm exactly — a lane that converges freezes, so results are
    independent of batch composition.

    Reverse-mode differentiable via the implicit function theorem (see
    ``_solve_htotal_bwd``): at the root, talk(h*, theta) = 0, so
    dh*/dtheta = -(dtalk/dtheta)/(dtalk/dh) — one extra talk evaluation
    instead of differentiating through the iteration.  This makes the whole
    model ``jax.grad``-able (parameter sensitivity / data assimilation), a
    capability the Fortran reference has no analogue of.
    """
    return _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2)


def solve_htotal_stats(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2,
                       x0=None):
    """Instrumented variant: returns (htotal, per-lane iteration count,
    per-lane converged flag) — the convergence observability the
    reference silently drops (co2calc.F90:993-995 commented-out abort).
    Not differentiable; for monitoring/analysis paths."""
    return _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2,
                              with_stats=True, x0=x0)


def _solve_htotal_impl(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2,
                       xacc=None, with_stats=False, x0=None,
                       trusted=None):
    dtype = jnp.result_type(x1, x2)
    if xacc is None:
        # the f64 contract uses the reference's xacc; the opt-in f32 fast
        # path needs a tolerance representable at single precision
        # (H ~ 1e-8 mol/kg, f32 eps ~ 1.2e-7 relative)
        xacc = XACC if dtype == jnp.float64 else 1e-5 * 1e-8
    x1 = jnp.asarray(x1, dtype)
    x2 = jnp.broadcast_to(jnp.asarray(x2, dtype), x1.shape)

    talk_fn = (talk_fast if dtype == jnp.float64 and _fast_f64_enabled()
               else talk)

    def f_of(x):
        return talk_fn(coeffs, dic, ta, pt, sit, x)

    def not_bracketed(flo, fhi):
        return ((flo > 0.0) & (fhi > 0.0)) | ((flo < 0.0) & (fhi < 0.0))

    def _any(mask):
        # jnp.any via an f32 max-reduce: same result, and it lowers
        # inside the Pallas kernel too (no bool or i64 reduction under
        # x64)
        return jnp.max(mask.astype(jnp.float32)) > 0.5

    def bracket_cond(carry):
        x1c, x2c, flo, fhi, it = carry
        return _any(not_bracketed(flo, fhi)) & (it < _BRACKET_GROW_GUARD)

    def bracket_body(carry):
        x1c, x2c, flo, fhi, it = carry
        m = not_bracketed(flo, fhi)
        growth = jnp.sqrt(x2c / x1c)
        x1n = jnp.where(m, x1c / growth, x1c)
        x2n = jnp.where(m, x2c * growth, x2c)
        flo_n, _ = f_of(x1n)
        fhi_n, _ = f_of(x2n)
        flo_n = jnp.where(m, flo_n, flo)
        fhi_n = jnp.where(m, fhi_n, fhi)
        return x1n, x2n, flo_n, fhi_n, it + 1

    def bracket_and_orient(_):
        """The reference's bracket phase: evaluate both endpoints, grow
        geometrically until the root is straddled, then orient so that
        f(xlo) < 0 (co2calc.F90:920-949).  Two whole-batch TA
        evaluations + the growth loop."""
        flo0, _ = f_of(x1)
        fhi0, _ = f_of(x2)
        x1b, x2b, flo, fhi, _ = jax.lax.while_loop(
            bracket_cond, bracket_body,
            (x1, x2, flo0, fhi0, jnp.asarray(0, jnp.int32)))
        neg_at_x1 = flo < 0.0
        return (jnp.where(neg_at_x1, x1b, x2b),
                jnp.where(neg_at_x1, x2b, x1b))

    if trusted is None:
        xlo, xhi = bracket_and_orient(None)
    else:
        # When EVERY lane carries a trusted bracket (a +/-DEL_PH window
        # around a previous root — either its own warm start or the
        # cached inactive-lane stand-in), the two endpoint evaluations
        # and the growth loop are pure overhead: the total-alkalinity
        # residual is strictly decreasing in H over the solver's whole
        # physical range (every species' charge fraction shifts
        # monotonically with acidity; the reference re-derives this
        # orientation numerically every call), so f(x1 = low H) > 0 >
        # f(x2 = high H) and the oriented bracket is statically
        # (xlo, xhi) = (x2, x1) — bitwise identical to what
        # bracket_and_orient returns whenever growth would not have
        # fired.  A single whole-batch any() picks the path at run
        # time, so the first (cold) step still takes the reference
        # bracket phase.  If a root escapes its warm window (> DEL_PH
        # pH drift in one step — outside the model's physical regime),
        # the iteration stalls at an endpoint instead of growing; the
        # health counters' residual check observes exactly that case
        # (ops/bgc.py::StepHealth).
        trusted_b = jnp.broadcast_to(jnp.asarray(trusted), x1.shape)
        xlo, xhi = jax.lax.cond(_any(trusted_b < 0.5),
                                bracket_and_orient,
                                lambda _: (x2, x1), None)

    soln0 = 0.5 * (xlo + xhi)
    if x0 is not None:
        # Seed the iteration at the caller's guess (the previous step's
        # root) instead of the bracket midpoint.  The reference starts
        # at the midpoint (drtsafe, co2calc.F90:951), which for the
        # warm +/-DEL_PH bracket is ~11% off in H and costs 2-3 Newton
        # iterations; the previous root is off only by one timestep's
        # pH drift (<< xacc), so most lanes converge in ONE (trip counts
        # from scripts/ph_iter_stats.py).  x0 <= 0 lanes (the cold
        # sentinel) keep the midpoint.  The guess is clamped into the
        # bracket so the safe-Newton invariants hold even if the root
        # escaped the warm window and the bracket grew; the converged
        # root agrees with the midpoint-seeded one to solver tolerance
        # (pinned by tests/test_carbonate.py).
        x0b = jnp.broadcast_to(jnp.asarray(x0, dtype), soln0.shape)
        lo = jnp.minimum(xlo, xhi)
        hi = jnp.maximum(xlo, xhi)
        soln0 = jnp.where(x0b > 0.0, jnp.clip(x0b, lo, hi), soln0)
    dxold0 = jnp.abs(xlo - xhi)
    f0, df0 = f_of(soln0)

    # the lane-active mask rides the carry as int32, not bool (the form
    # the Pallas kernel's while loop was written for)
    active0 = jnp.ones_like(soln0, dtype=jnp.int32)
    # the per-lane iteration counter is observability-only, so it only
    # exists on the stats path
    iters0 = (jnp.zeros_like(soln0, dtype=jnp.int32) if with_stats
              else jnp.zeros((), jnp.int32))

    def iter_cond(carry):
        _, _, _, _, _, _, _, active_i, _, it = carry
        return _any(active_i > 0) & (it < MAXIT)

    def iter_body(carry):
        soln, xlo_c, xhi_c, f, df, dx, dxold, active_i, iters, it = carry
        active = active_i > 0
        # choose bisection when Newton would leave the bracket or is
        # converging too slowly (co2calc.F90:962-976)
        leave_bracket = (((soln - xhi_c) * df - f)
                         * ((soln - xlo_c) * df - f)) >= 0.0
        dx_decrease = jnp.abs(2.0 * f) <= jnp.abs(dxold * df)
        bisect = leave_bracket | (~dx_decrease)

        dxold_n = dx
        dx_bis = 0.5 * (xhi_c - xlo_c)
        dx_newt = -f / df
        dx_n = jnp.where(bisect, dx_bis, dx_newt)
        soln_n = jnp.where(bisect, xlo_c + dx_bis, soln + dx_newt)
        # logical form of where(bisect, xlo==soln_n, soln==soln_n)
        stalled = ((bisect & (xlo_c == soln_n))
                   | (~bisect & (soln == soln_n)))
        converged = stalled | (jnp.abs(dx_n) < xacc)

        soln_out = jnp.where(active, soln_n, soln)
        dx_out = jnp.where(active, dx_n, dx)
        dxold_out = jnp.where(active, dxold_n, dxold)
        active_n = active & (~converged)

        f_n, df_n = f_of(soln_out)
        f_out = jnp.where(active_n, f_n, f)
        df_out = jnp.where(active_n, df_n, df)
        # re-bracket (co2calc.F90:983-989)
        go_lo = (f_n < 0.0) & active_n
        go_hi = (f_n >= 0.0) & active_n
        xlo_out = jnp.where(go_lo, soln_out, xlo_c)
        xhi_out = jnp.where(go_hi, soln_out, xhi_c)
        iters_out = (iters + active_i if with_stats else iters)
        return (soln_out, xlo_out, xhi_out, f_out, df_out, dx_out,
                dxold_out, active_n.astype(jnp.int32), iters_out, it + 1)

    (soln, _, _, _, _, _, _, still_active, iters, _) = jax.lax.while_loop(
        iter_cond, iter_body,
        (soln0, xlo, xhi, f0, df0, dxold0, dxold0, active0, iters0,
         jnp.asarray(0, jnp.int32)))
    if with_stats:
        return soln, iters, still_active == 0
    return soln


def _solve_htotal_fwd(coeffs, dic, ta, pt, sit, x1, x2):
    h = _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2)
    return h, (coeffs, dic, ta, pt, sit, h, x1, x2)


def _solve_htotal_bwd(res, g):
    coeffs, dic, ta, pt, sit, h, x1, x2 = res
    # implicit function theorem at the root: F(h*, theta) = 0
    # => dL/dtheta = -(dL/dh*) / F_h  *  F_theta
    _, f_h = talk(coeffs, dic, ta, pt, sit, h)
    lam = -g / f_h

    def residual(coeffs_, dic_, ta_, pt_, sit_):
        fn, _ = talk(coeffs_, dic_, ta_, pt_, sit_, h)
        return fn

    _, vjp = jax.vjp(residual, coeffs, dic, ta, pt, sit)
    d_coeffs, d_dic, d_ta, d_pt, d_sit = vjp(lam)
    # the solution is independent of the bracket endpoints
    return (d_coeffs, d_dic, d_ta, d_pt, d_sit,
            jnp.zeros_like(x1), jnp.zeros_like(x2))


solve_htotal.defvjp(_solve_htotal_fwd, _solve_htotal_bwd)


@jax.custom_vjp
def solve_htotal_warm(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2, x0,
                      trusted):
    """:func:`solve_htotal` with the two warm-regime accelerations:

    ``trusted`` (float mask, 1.0 = this lane's bracket is a warm
    +/-DEL_PH window around a previous root): when every lane is
    trusted the bracket phase's two endpoint evaluations and growth
    loop are skipped and the orientation is static — BITWISE identical
    results (see ``_solve_htotal_impl``'s fast-path note), picked per
    call by one runtime any().

    ``x0`` (previous root per lane, 0 = cold sentinel): start the
    iteration at the previous root instead of the bracket midpoint —
    ~1 iteration instead of 2-3, returning the same root to solver
    tolerance (NOT bitwise: the iterate sequence differs, so this one
    is opt-in, OBGC_X0_SEED=1; pass all-zeros for the bitwise
    midpoint start).

    Differentiable via the same implicit-function-theorem VJP as
    :func:`solve_htotal` (the root is independent of bracket, seed,
    and mask)."""
    return _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2, x0=x0,
                              trusted=trusted)


def _solve_htotal_warm_fwd(coeffs, dic, ta, pt, sit, x1, x2, x0,
                           trusted):
    h = _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2, x0=x0,
                           trusted=trusted)
    return h, (coeffs, dic, ta, pt, sit, h, x1, x2, x0, trusted)


def _solve_htotal_warm_bwd(res, g):
    *grads, d_x1, d_x2 = _solve_htotal_bwd(res[:8], g)
    return (*grads, d_x1, d_x2, jnp.zeros_like(res[8]),
            jnp.zeros_like(res[9]))


solve_htotal_warm.defvjp(_solve_htotal_warm_fwd, _solve_htotal_warm_bwd)


def _to_mass_units(dic_in, ta_in, pt_in, sit_in):
    """Floor tracers and convert (mmol/m^3) -> (mol/kg) (comp_htotal,
    co2calc.F90:843-846)."""
    dic = jnp.maximum(dic_in, DIC_MIN) * VOL_TO_MASS
    ta = jnp.maximum(ta_in, ALK_MIN) * VOL_TO_MASS
    pt = jnp.maximum(pt_in, 0.0) * VOL_TO_MASS
    sit = jnp.maximum(sit_in, 0.0) * VOL_TO_MASS
    return dic, ta, pt, sit


def comp_htotal(coeffs: CarbCoeffs, dic_in, ta_in, pt_in, sit_in,
                phlo, phhi):
    """Solve for free H+ from (DIC, TA) with a pH bracket
    (comp_htotal, co2calc.F90:781-868)."""
    dic, ta, pt, sit = _to_mass_units(dic_in, ta_in, pt_in, sit_in)
    x1 = 10.0 ** (-phhi)
    x2 = 10.0 ** (-phlo)
    htotal = solve_htotal(coeffs, dic, ta, pt, sit, x1, x2)
    return htotal, dic


def co3_terms(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in,
              phlo, phhi, apply_pressure):
    """Carbonate speciation H2CO3/HCO3/CO3 + pH (comp_CO3terms,
    co2calc.F90:214-316). Returns concentrations in mmol/m^3."""
    coeffs = carbonate_coeffs(depth_m, temp, salt, apply_pressure,
                              k1_k2_ph_tot=True)
    htotal, dic = comp_htotal(coeffs, dic_in, ta_in, pt_in, sit_in,
                              phlo, phhi)
    htotal2 = htotal ** 2
    denom = 1.0 / (htotal2 + coeffs.k1 * htotal + coeffs.k1 * coeffs.k2)
    h2co3 = dic * htotal2 * denom * MASS_TO_VOL
    hco3 = dic * coeffs.k1 * htotal * denom * MASS_TO_VOL
    co3 = dic * coeffs.k1 * coeffs.k2 * denom * MASS_TO_VOL
    ph = -jnp.log10(htotal)
    return ph, h2co3, hco3, co3


def warm_brackets_h(ph_prev, lo_init, hi_init, del_ph, with_seed=False):
    """H-space warm-start brackets with ONE transcendental per cell.

    The reference brackets a warm-started solve at ph_prev +/- del_ph
    (BGC_mod.F90:943-956) and the solver needs H-space endpoints, so the
    direct form costs two pows per cell: 10**-(ph+del) and 10**-(ph-del).
    Since 10**-(ph +/- del) == (10**-ph) * 10**(-/+ del) and del_ph is a
    compile-time constant, one pow plus two constant multiplies gives
    the same endpoints to within 1 ulp.  Cold lanes (ph_prev == 0, the
    no-previous-solution sentinel) take the constant wide bracket
    [10**-hi_init, 10**-lo_init], constant-folded by XLA — bitwise
    identical to the direct form there.  The bracket endpoints only
    seed the root search (the returned root is converged to xacc and
    the solution is independent of the endpoints — see
    _solve_htotal_bwd), so the 1-ulp endpoint change stays inside the
    solver-tolerance envelope the trajectory gates already allow.
    Range audit: h_prev in [1e-10, 1e-6] for any physical pH; the
    constants 10**(+/-del) are O(1); derivative d x/d ph = -ln10 * x is
    in range; the cold stand-in pH 8.0 keeps the discarded lane benign.
    """
    warm = ph_prev != 0.0
    h_prev = 10.0 ** -jnp.where(warm, ph_prev, 8.0)
    x1 = jnp.where(warm, h_prev * (10.0 ** -del_ph), 10.0 ** -hi_init)
    x2 = jnp.where(warm, h_prev * (10.0 ** del_ph), 10.0 ** -lo_init)
    if with_seed:
        # the previous root itself, as the iteration seed for
        # solve_htotal_warm (0 = cold sentinel -> bracket midpoint)
        return x1, x2, jnp.where(warm, h_prev, 0.0)
    return x1, x2


def co3_terms_dual(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in,
                   phlo_a, phhi_a, phlo_b, phhi_b, apply_pressure,
                   *, coeffs: CarbCoeffs = None, brackets_a=None,
                   brackets_b=None, trusted_a=None, trusted_b=None):
    """Two pH solves of the SAME (DIC, TA) cell from two warm-start
    brackets — the reference's ambient + ALT_CO2 interior pattern
    (BGC_mod.F90:952-978).  The equilibrium coefficients depend only on
    (T, S, depth), so they are computed once and shared (the reference
    recomputes identical values); the two solves are stacked into one
    lane batch so their solver iterations merge into a single masked
    while_loop.  Bit-identical results to two co3_terms calls.

    ``coeffs``: optionally supply precomputed equilibrium constants
    (the forcing-invariant coefficient cache, ops/bgc.py::EnvCache) —
    the cache evaluates the same expressions on the same inputs.

    ``brackets_a`` / ``brackets_b``: optionally supply H-space bracket
    endpoints ``(x1, x2)`` — or ``(x1, x2, x0)`` with an iteration seed
    (``warm_brackets_h(..., with_seed=True)``) — directly, skipping the
    per-cell 10**-ph conversions; the corresponding phlo/phhi arguments
    are then ignored.  Consumed by BOTH the sequential (f64) and the
    stacked (f32 / OBGC_DUAL_STACK_F64) branches.

    ``trusted_a`` / ``trusted_b``: optional float masks (1.0 = warm
    bracket) enabling the bitwise bracket-phase skip — see
    :func:`solve_htotal_warm`.

    Returns ((ph, h2co3, hco3, co3) for bracket a, same for bracket b).
    """
    if coeffs is None:
        coeffs = carbonate_coeffs(depth_m, temp, salt, apply_pressure,
                                  k1_k2_ph_tot=True)
    dic, ta, pt, sit = _to_mass_units(dic_in, ta_in, pt_in, sit_in)

    if dic.dtype == jnp.float32 or _DUAL_STACK_F64:
        # stack the two scenarios along a leading axis: ONE masked
        # while_loop covers both, so the trip count is max(a, b) instead
        # of a+b (per-lane freezing makes each lane's result independent
        # of its batchmates — identical to two separate solves).
        # f64 keeps sequential solves (the doubled per-iteration working
        # set against the merged trips; OBGC_DUAL_STACK_F64=1 measures
        # the stacked form).
        if brackets_a is not None:
            x1 = jnp.stack([jnp.broadcast_to(brackets_a[0], dic.shape),
                            jnp.broadcast_to(brackets_b[0], dic.shape)])
            x2 = jnp.stack([jnp.broadcast_to(brackets_a[1], dic.shape),
                            jnp.broadcast_to(brackets_b[1], dic.shape)])
        else:
            x1 = jnp.stack([jnp.broadcast_to(10.0 ** (-phhi_a), dic.shape),
                            jnp.broadcast_to(10.0 ** (-phhi_b), dic.shape)])
            x2 = jnp.stack([jnp.broadcast_to(10.0 ** (-phlo_a), dic.shape),
                            jnp.broadcast_to(10.0 ** (-phlo_b), dic.shape)])
        if trusted_a is not None or (brackets_a is not None
                                     and len(brackets_a) == 3):
            if brackets_a is not None and len(brackets_a) == 3:
                x0 = jnp.stack(
                    [jnp.broadcast_to(brackets_a[2], dic.shape),
                     jnp.broadcast_to(brackets_b[2], dic.shape)])
            else:
                x0 = jnp.zeros_like(x1)
            if trusted_a is not None:
                tr = jnp.stack(
                    [jnp.broadcast_to(trusted_a, dic.shape),
                     jnp.broadcast_to(trusted_b, dic.shape)])
            else:
                tr = jnp.zeros_like(x1)
            htotal = solve_htotal_warm(coeffs, dic, ta, pt, sit, x1, x2,
                                       x0, tr)
        else:
            htotal = solve_htotal(coeffs, dic, ta, pt, sit, x1, x2)

        htotal2 = htotal ** 2
        denom = 1.0 / (htotal2 + coeffs.k1 * htotal
                       + coeffs.k1 * coeffs.k2)
        ph = -jnp.log10(htotal)
        h2co3 = dic * htotal2 * denom * MASS_TO_VOL
        hco3 = dic * coeffs.k1 * htotal * denom * MASS_TO_VOL
        co3 = dic * coeffs.k1 * coeffs.k2 * denom * MASS_TO_VOL
        co3 = jnp.broadcast_to(co3, htotal.shape)
        return ((ph[0], h2co3[0], hco3[0], co3[0]),
                (ph[1], h2co3[1], hco3[1], co3[1]))

    def one(phlo, phhi, brackets, trusted):
        if brackets is not None:
            x1, x2 = brackets[0], brackets[1]
        else:
            x1 = 10.0 ** (-phhi)
            x2 = 10.0 ** (-phlo)
        if trusted is not None or (brackets is not None
                                   and len(brackets) == 3):
            x0 = (brackets[2] if brackets is not None
                  and len(brackets) == 3 else jnp.zeros_like(dic))
            tr = trusted if trusted is not None else jnp.zeros_like(dic)
            htotal = solve_htotal_warm(coeffs, dic, ta, pt, sit, x1, x2,
                                       x0, tr)
        else:
            htotal = solve_htotal(coeffs, dic, ta, pt, sit, x1, x2)
        htotal2 = htotal ** 2
        denom = 1.0 / (htotal2 + coeffs.k1 * htotal
                       + coeffs.k1 * coeffs.k2)
        h2co3 = dic * htotal2 * denom * MASS_TO_VOL
        hco3 = dic * coeffs.k1 * htotal * denom * MASS_TO_VOL
        co3 = dic * coeffs.k1 * coeffs.k2 * denom * MASS_TO_VOL
        return -jnp.log10(htotal), h2co3, hco3, co3

    return (one(phlo_a, phhi_a, brackets_a, trusted_a),
            one(phlo_b, phhi_b, brackets_b, trusted_b))


def co2calc_surface_dual(depth_m, temp, salt, dic_a, dic_b, ta_in, pt_in,
                         sit_in, phlo_a, phhi_a, phlo_b, phhi_b,
                         xco2_a, xco2_b, atmpres, *,
                         locmip_k1_k2_bug_fix=True, brackets_a=None,
                         brackets_b=None, trusted_a=None,
                         trusted_b=None):
    """The surface ambient + ALT_CO2 pair (BGC_mod.F90:2881-2912): shared
    coefficients, DIC/xCO2/bracket differing per scenario, one stacked
    solve.  Returns two (ph, co2star, dco2star, pco2surf, dpco2) tuples."""
    coeffs = carbonate_coeffs(depth_m, temp, salt, False,
                              k1_k2_ph_tot=locmip_k1_k2_bug_fix)
    da, ta, pt, sit = _to_mass_units(dic_a, ta_in, pt_in, sit_in)
    db, _, _, _ = _to_mass_units(dic_b, ta_in, pt_in, sit_in)

    # one stacked solve for both scenarios (see co3_terms_dual)
    dic = jnp.stack([da, db])
    shp = da.shape
    if brackets_a is not None:
        x1 = jnp.stack([jnp.broadcast_to(brackets_a[0], shp),
                        jnp.broadcast_to(brackets_b[0], shp)])
        x2 = jnp.stack([jnp.broadcast_to(brackets_a[1], shp),
                        jnp.broadcast_to(brackets_b[1], shp)])
    else:
        x1 = jnp.stack([jnp.broadcast_to(10.0 ** (-phhi_a), shp),
                        jnp.broadcast_to(10.0 ** (-phhi_b), shp)])
        x2 = jnp.stack([jnp.broadcast_to(10.0 ** (-phlo_a), shp),
                        jnp.broadcast_to(10.0 ** (-phlo_b), shp)])
    if trusted_a is not None or (brackets_a is not None
                                 and len(brackets_a) == 3):
        if brackets_a is not None and len(brackets_a) == 3:
            x0 = jnp.stack([jnp.broadcast_to(brackets_a[2], shp),
                            jnp.broadcast_to(brackets_b[2], shp)])
        else:
            x0 = jnp.zeros_like(x1)
        if trusted_a is not None:
            tr = jnp.stack([jnp.broadcast_to(trusted_a, shp),
                            jnp.broadcast_to(trusted_b, shp)])
        else:
            tr = jnp.zeros_like(x1)
        htotal = solve_htotal_warm(coeffs, dic, ta, pt, sit, x1, x2, x0,
                                   tr)
    else:
        htotal = solve_htotal(coeffs, dic, ta, pt, sit, x1, x2)

    xco2 = jnp.stack([jnp.broadcast_to(jnp.asarray(xco2_a, da.dtype), shp),
                      jnp.broadcast_to(jnp.asarray(xco2_b, da.dtype),
                                       shp)]) * 1e-6
    htotal2 = htotal ** 2
    co2star = dic * htotal2 / (htotal2 + coeffs.k1 * htotal
                               + coeffs.k1 * coeffs.k2)
    dco2star = xco2 * coeffs.ff * atmpres - co2star
    pco2surf = co2star / coeffs.ff
    dpco2 = pco2surf - xco2 * atmpres
    ph = -jnp.log10(htotal)

    def pick(i):
        return (ph[i], co2star[i] * MASS_TO_VOL,
                dco2star[i] * MASS_TO_VOL, pco2surf[i] * 1e6,
                dpco2[i] * 1e6)

    return pick(0), pick(1)


def co2calc_surface(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in,
                    phlo, phhi, xco2_in, atmpres, *,
                    locmip_k1_k2_bug_fix=True):
    """Surface CO2* / delta-CO2* / pCO2 (co2calc_1point, co2calc.F90:75-210).

    Always the surface level: no pressure corrections (reference passes
    k = 1).  Returns (ph, co2star, dco2star, pco2surf, dpco2) with co2star
    terms in mmol/m^3 and pCO2 in ppmv.
    """
    coeffs = carbonate_coeffs(depth_m, temp, salt, False,
                              k1_k2_ph_tot=locmip_k1_k2_bug_fix)
    htotal, dic = comp_htotal(coeffs, dic_in, ta_in, pt_in, sit_in,
                              phlo, phhi)
    xco2 = xco2_in * 1e-6
    htotal2 = htotal ** 2
    co2star = dic * htotal2 / (htotal2 + coeffs.k1 * htotal
                               + coeffs.k1 * coeffs.k2)
    co2starair = xco2 * coeffs.ff * atmpres
    dco2star = co2starair - co2star
    ph = -jnp.log10(htotal)
    pco2surf = co2star / coeffs.ff
    dpco2 = pco2surf - xco2 * atmpres
    return (ph,
            co2star * MASS_TO_VOL,
            dco2star * MASS_TO_VOL,
            pco2surf * 1e6,
            dpco2 * 1e6)


def co3_sat_vals(depth_m, temp, salt, apply_pressure):
    """CO3= concentration at calcite and aragonite saturation
    (comp_co3_sat_vals, co2calc.F90:1096-1238); Mucci 1983 solubilities
    with Millero 1979 pressure corrections.  Returns mmol/m^3."""
    press = press_bar_from_depth(depth_m)
    apply_pressure = jnp.asarray(apply_pressure)

    salt_lim = jnp.maximum(salt, SALT_MIN)
    tk = T0_KELVIN + temp
    log10tk = jnp.log(tk) / _LN10
    invtk = 1.0 / tk
    invRtk = INV_R_GAS * invtk
    sqrts = jnp.sqrt(salt_lim)
    s15 = sqrts * salt_lim

    deltaV_calc = -48.76 + 0.5304 * temp
    kappa = (-11.76 + 0.3692 * temp) * 1e-3
    # pressure corrections folded into the solubility exps (log-space
    # add gated to exactly 0.0 at the surface — see _pressure_ln_factor)
    ln_fac_calc = _pressure_ln_factor(deltaV_calc, kappa, press, invRtk)
    k_calc = jnp.exp(_LN10 * (
        -171.9065 - 0.077993 * tk + 2839.319 * invtk + 71.595 * log10tk
        + (-0.77712 + 0.0028426 * tk + 178.34 * invtk) * sqrts
        - 0.07711 * salt_lim + 0.0041249 * s15)
        + jnp.where(apply_pressure, ln_fac_calc, 0.0))

    # the reference reuses the calcite correction with deltaV shifted by
    # +2.8 and the same kappa (co2calc.F90:1212-1221)
    ln_fac_arag = _pressure_ln_factor(deltaV_calc + 2.8, kappa, press,
                                      invRtk)
    k_arag = jnp.exp(_LN10 * (
        -171.945 - 0.077993 * tk + 2903.293 * invtk + 71.595 * log10tk
        + (-0.068393 + 0.0017276 * tk + 88.135 * invtk) * sqrts
        - 0.10018 * salt_lim + 0.0059415 * s15)
        + jnp.where(apply_pressure, ln_fac_arag, 0.0))

    inv_ca = (35.0 / 0.01028) / salt_lim
    co3_sat_calc = k_calc * inv_ca * MASS_TO_VOL
    co3_sat_arag = k_arag * inv_ca * MASS_TO_VOL
    return co3_sat_calc, co3_sat_arag
