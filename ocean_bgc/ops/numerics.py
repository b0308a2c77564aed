"""Range-safe numerical primitives.

Every intermediate, forward and backward, stays inside float32's
~1e+/-38 exponent range, so the float32 path computes what the float64
path computes (CLAUDE.md, "Numerics").  Forward code has been
range-audited, but reverse-mode AD *derives* new expressions — in
particular the standard division VJP forms ``num/den**2``, whose
``den**2`` flushes to zero in float32 for ``den < ~1e-19`` and returns
inf (float64 keeps it normal, so a float64 test cannot catch it).

:func:`safe_div` is the shared guarded division with a den**2-free
custom derivative; use it for ANY division whose denominator can be
arbitrarily tiny (biology ratios, flux ratios), not just for the
den==0 guard.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# two-band Morel (2001) chlorophyll attenuation fit, shared by the BGC
# and DMS PAR fields (BGC_mod.F90:907-924, DMS_mod.F90:538-551 — the
# reference states the identical fit in both kernels).  Prefactors as
# log-space trace-time constants for the shared-log rewrite below.
_MOREL_BREAK = 0.13224
_LOG_MOREL_A1 = math.log(0.000919)
_LOG_MOREL_A2 = math.log(0.001131)
_MOREL_P1 = 0.3536
_MOREL_P2 = 0.4562


def morel_kpar(chl):
    """PAR attenuation coefficient (1/cm) from total chlorophyll.

    Evaluated as ``exp(log(a) + p*log(chl))`` with one shared log —
    1 log + 1 exp per cell instead of the fit's two pows (the f64 win
    is op-count only, but at f32 transcendentals are hardware
    special-function work).  Equal to the pow form to ~1 ulp; qualified
    by the oracle suites' PAR-path envelopes and the trajectory gates.
    Range audit: callers floor chl at 0.02 -> log in [-3.9, ~4.6]; the
    folded exponent stays in [-8.4, -4.6]; d kpar/d chl = p*kpar/chl is
    in range for chl >= 0.02.
    """
    log_chl = jnp.log(chl)
    return jnp.exp(jnp.where(chl < _MOREL_BREAK,
                             _LOG_MOREL_A1 + _MOREL_P1 * log_chl,
                             _LOG_MOREL_A2 + _MOREL_P2 * log_chl))


@jax.custom_jvp
def safe_div(num, den):
    """num/den with den==0 mapped to 0 (guarded selects, not NaN).

    Carries a custom derivative because the standard division VJP forms
    ``num/den**2`` — ``den**2`` underflows float32's exponent range
    for ``den < ~1e-19`` and the quotient becomes inf.  The
    photoadaptation ratio ``pcphoto/work1`` with ``work1 =
    alphaPI*thetaC*PAR_avg ~ 1e-21`` in deep cells reaches that range,
    which once sent every BGC parameter gradient to NaN while float64
    stayed finite.  The derivative is re-associated as ``q*(1/den)`` —
    the same value through factors that each stay inside the float32
    range.  The actual condition is that
    ``q = num/den`` and ``1/den`` each stay below ~1e38 — automatic
    when num scales with den (most call sites), but a call site with a
    CONSTANT numerator over an arbitrarily tiny denominator must bound
    ``num/den`` itself (see the GQSI site in ops/bgc.py: q <= C/fe with
    C ~ 1e-4, ~1e34 at the float32 flush threshold fe ~ 1e-38 —
    inside range, but only because C is small; a larger constant there
    would need its own guard)."""
    return jnp.where(den != 0.0, num / jnp.where(den != 0.0, den, 1.0), 0.0)


@safe_div.defjvp
def _safe_div_jvp(primals, tangents):
    num, den = primals
    dnum, dden = tangents
    nz = den != 0.0
    den1 = jnp.where(nz, den, 1.0)
    inv = 1.0 / den1
    q = jnp.where(nz, num / den1, 0.0)   # primal identical to safe_div
    # d(num/den) = dnum/den - (num/den)*(dden/den), NO den**2 term
    dq = jnp.where(nz, inv * dnum - q * (inv * dden),
                   jnp.zeros_like(q))
    return q, dq
