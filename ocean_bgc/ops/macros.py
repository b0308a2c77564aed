"""Macromolecule (proteins / polysaccharides / lipids) source-sink kernel.

Re-design of MACROS_SourceSink (MACROS_mod.F90:137-411): three first-order
production/removal pairs driven by total phytoplankton carbon and a
zooplankton-modulated disruption rate.  No vertical coupling at all
(MACROS_mod.F90:340 k-loop is pure per-cell algebra), so the whole kernel
is one fused elementwise map over (nlev, ncol) — the minimal end-to-end
slice of the framework.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ocean_bgc.params import MACROSParams
from ocean_bgc.state import MACROSTracers as MT


def macros_source_sink(
    tracers: jax.Array,          # (nlev, MT.CNT, ncol)
    active_mask: jax.Array,      # (nlev, ncol) bool
    params: MACROSParams,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Tendencies (nlev, MT.CNT, ncol) and the 6 diagnostics
    (MACROS_parms.F90:105-113).  Inactive cells produce zeros."""

    clip = lambda i: jnp.maximum(tracers[:, i], 0.0)  # noqa: E731
    zooC = clip(MT.ZOOC)
    spC = clip(MT.SPC)
    diatC = clip(MT.DIATC)
    diazC = clip(MT.DIAZC)
    phaeoC = clip(MT.PHAEOC)
    prot = clip(MT.PROT)
    poly = clip(MT.POLY)
    lip = clip(MT.LIP)

    # zoo-modulated disruption rate (MACROS_mod.F90:349)
    k_C_p = params.k_C_p_base * (params.mort + zooC / params.zooC_avg)

    phytoC = diatC + phaeoC + spC + diazC   # (MACROS_mod.F90:366)

    prot_s = params.inject_scale * params.f_prot * k_C_p * phytoC
    poly_s = params.inject_scale * params.f_poly * k_C_p * phytoC
    lip_s = params.inject_scale * params.f_lip * k_C_p * phytoC

    prot_r = params.k_prot_bac * prot
    poly_r = params.k_poly_bac * poly
    lip_r = params.k_lip_bac * lip

    zero = jnp.zeros_like(prot)
    mask = active_mask

    def masked(x):
        return jnp.where(mask, x, 0.0)

    tend = [zero] * MT.CNT
    tend[MT.PROT] = masked(prot_s - prot_r)
    tend[MT.POLY] = masked(poly_s - poly_r)
    tend[MT.LIP] = masked(lip_s - lip_r)
    tendencies = jnp.stack(tend, axis=1)

    diags = {
        "PROT_S_TOTAL": masked(prot_s),
        "POLY_S_TOTAL": masked(poly_s),
        "LIP_S_TOTAL": masked(lip_s),
        "PROT_R_TOTAL": masked(prot_r),
        "POLY_R_TOTAL": masked(poly_r),
        "LIP_R_TOTAL": masked(lip_r),
    }
    return tendencies, diags
