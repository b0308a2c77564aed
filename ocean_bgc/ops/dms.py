"""DMS / DMSP sulfur-cycle source-sink kernel.

Re-design of DMS_SourceSink (DMS_mod.F90:156-770): fuzzy partition of the
small-phytoplankton pool into coccolithophore / cyanobacteria / eukaryote
fractions, nitrogen- and sulfur-currency conversions, diagnosed bacteria,
and first/second-order DMS & DMSP kinetics.

Only the PAR (and UV) attenuation is vertically sequential
(DMS_mod.F90:531-551) — and because each cell's absorption depends only
on that cell's own chlorophyll (resp. DOC), the downward recurrence has
the closed form PAR_in(k) = PAR_surf * prod_{j<k} exp(-KPARdz(j)): one
cumulative product over the level axis.  The whole kernel is therefore
fully batched over (nlev, ncol) cells with no scan at all; columns ride
the vector lanes.  (The reference also computes a UV attenuation field,
DMS_mod.F90:531-536, but never consumes it pending its CODiM update — it
is opt-in here via ``compute_uv=True``, because an unconsumed
computation is exactly what XLA's dead-code elimination would drop
anyway; opting in restores field-for-field parity.)
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ocean_bgc.constants import EPSC, F_QSW_PAR_DMS
from ocean_bgc.ops.numerics import morel_kpar, safe_div
from ocean_bgc.params import DMSParams
from ocean_bgc.state import DMSTracers as DT

DMS_DIAG_NAMES = (
    "DMS_S_DMSP", "DMS_S_TOTAL",
    "DMS_R_B", "DMS_R_PHOT", "DMS_R_BKGND", "DMS_R_TOTAL",
    "DMSP_S_PHAEO", "DMSP_S_NONPHAEO", "DMSP_S_ZOO", "DMSP_S_TOTAL",
    "DMSP_R_B", "DMSP_R_BKGND", "DMSP_R_TOTAL",
    "Cyano_frac", "Cocco_frac", "Eukar_frac",
    "diatS", "diatN", "phytoN", "coccoS", "cyanoS", "eukarS", "diazS",
    "phaeoS", "zooS", "zooCC", "RSNzoo",
)


def dms_source_sink(
    tracers: jax.Array,         # (nlev, DT.CNT, ncol)
    cell_thickness: jax.Array,  # (nlev, ncol) cm
    active_mask: jax.Array,     # (nlev, ncol) bool
    sst: jax.Array,             # (ncol,)
    shortwave_surface: jax.Array,  # (ncol,) W/m^2
    params: DMSParams,
    *,
    compute_uv: bool = False,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Tendencies (nlev, DT.CNT, ncol) and the 27 diagnostics
    (DMS_parms.F90:125-154), each a (nlev, ncol) field.

    ``compute_uv``: also emit the DOC-attenuated UV field as three extra
    diagnostics ``UV_in``/``UV_out``/``UV_avg`` (DMS_mod.F90:509-510,
    531-536).  The reference computes this field on every call but never
    consumes it (pending its CODiM update), so the default here is off —
    which is exactly what XLA's dead-code elimination would do to an
    unconsumed computation — and opting in restores full
    field-for-field computational parity."""

    p = params

    clip = jnp.maximum(tracers, 0.0)   # (DMS_mod.F90:471-485)

    dms = clip[:, DT.DMS]
    dmsp = clip[:, DT.DMSP]
    doc = clip[:, DT.DOC]
    zooC = clip[:, DT.ZOOC]
    spC = clip[:, DT.SPC]
    spCaCO3 = clip[:, DT.SPCACO3]
    diatC = clip[:, DT.DIATC]
    diazC = clip[:, DT.DIAZC]
    phaeoC = clip[:, DT.PHAEOC]
    spChl = clip[:, DT.SPCHL]
    diatChl = clip[:, DT.DIATCHL]
    diazChl = clip[:, DT.DIAZCHL]
    phaeoChl = clip[:, DT.PHAEOCHL]

    dz = cell_thickness
    active = active_mask

    # surface initialization (DMS_mod.F90:504-510) and the whole-column
    # PAR attenuation (DMS_mod.F90:538-551) in closed form: exclusive
    # cumulative product of the per-cell decay factors.  The reference's
    # k-loop stops at the ocean floor (`do k = 1, kmax`,
    # DMS_mod.F90:516), so cells below it never receive a PAR value —
    # but an UNMASKED cumprod is still equivalent: a sub-floor cell's
    # attenuation only shades cells deeper than itself (all inactive),
    # and every tendency/diagnostic is masked by ``active`` before it
    # leaves this function.  Pinned on a ragged world by
    # tests/test_dms.py::test_dms_ragged_matches_oracle.
    par_surf = jnp.maximum(shortwave_surface, 0.0) * F_QSW_PAR_DMS

    total_chl = spChl + diatChl + diazChl + phaeoChl
    chl = jnp.maximum(total_chl, 0.02)
    # two-band Morel fit (DMS_mod.F90:538-551) via the shared helper
    # (ops/numerics.py::morel_kpar: shared-log rewrite + range audit)
    kpar = morel_kpar(chl)
    kpar_dz = kpar * dz
    att = jnp.exp(-kpar_dz)
    cum = jnp.cumprod(att, axis=0)
    ones = jnp.ones_like(cum[:1])
    par_in = par_surf[None, :] * jnp.concatenate([ones, cum[:-1]], axis=0)
    par_avg = par_in * (1.0 - att) / kpar_dz

    # zoo-modulated phyto S release constant (DMS_mod.F90:529);
    # the reference hard-codes the 0.3 zooC normalization here
    k_S_p = p.k_S_p_base * (p.mort + zooC / 0.3)

    # photolysis scales with PAR (DMS_mod.F90:562)
    j_dms = p.j_dms_perI * par_avg

    # coccolithophore fraction from CaCO3 quota (DMS_mod.F90:570-573)
    fcocco = jnp.minimum(spCaCO3 / (spC + EPSC), 0.4)
    cocco_frac = fcocco

    # SST-interpolated cyanobacteria fraction (DMS_mod.F90:584-592)
    t_ind = jnp.clip((sst - p.T_lo) / (p.T_hi - p.T_lo), 0.0, 1.0)
    cyano_frac = (t_ind * (p.Max_cyano_frac - p.Min_cyano_frac)
                  + p.Min_cyano_frac)
    cyano_frac = (1.0 - cocco_frac) * cyano_frac
    eukar_frac = 1.0 - cocco_frac - cyano_frac

    # nitrogen currency (DMS_mod.F90:598-604)
    diatN = p.R * diatC
    phaeoN = p.R * phaeoC
    coccoN = cocco_frac * p.R * spC
    cyanoN = cyano_frac * p.R * spC
    eukarN = eukar_frac * p.R * spC
    diazN = p.R * diazC
    zooN = p.R * zooC
    phytoN = diatN + coccoN + cyanoN + eukarN + diazN + phaeoN

    # oxidant-stress upregulation via chlorophyll decrement
    # (DMS_mod.F90:621-628)
    sp_dec = jnp.clip((p.Sp_ref - spChl) / p.Sp_ref, 0.0, 1.0)
    stress_fac = jnp.minimum(1.0 + p.Stress_mult * sp_dec * sp_dec, 10.0)

    # temperature-dependent bacterial yield with cryoprotection
    # overrides (DMS_mod.F90:637-640)
    yield_ = t_ind * (p.Max_yld - p.Min_yld) + p.Min_yld
    yield_ = jnp.where((sst < p.T_cryo_hi) & (sst > p.T_cryo_lo),
                       0.5, yield_)
    yield_ = jnp.where(sst < -1.0, 0.25, yield_)
    yield_ = jnp.broadcast_to(yield_, dms.shape)

    # per-class sulfur content (DMS_mod.F90:647-660)
    diatS = p.Rs2n_diat * diatN
    phaeoS = p.Rs2n_phaeo * phaeoN
    coccoS = p.Rs2n_cocco * coccoN
    cyanoS = p.Rs2n_cyano * cyanoN
    eukarS = p.Rs2n_eukar * eukarN * stress_fac
    diazS = p.Rs2n_diaz * diazN
    phytoS = (diatS + coccoS + cyanoS + eukarS + diazS
              + p.G_phaeo_S * phaeoS)

    # food-weighted zooplankton sulfur (DMS_mod.F90:671-684)
    # safe_div: phytoN can be arbitrarily tiny at depth, where the
    # standard division VJP's phytoN**2 underflows in float32
    # (ops/numerics.py);
    # the phytoN<=0 value (0 vs the old X/1) is discarded by the
    # phytoN>0 select below either way
    rs2n_zoo_weighted = safe_div(
        p.Rs2n_diat * diatN
        + p.G_phaeo_S * p.Rs2n_phaeo * phaeoN
        + p.Rs2n_cocco * coccoN
        + p.Rs2n_cyano * cyanoN
        + p.Rs2n_eukar * eukarN * stress_fac
        + p.Rs2n_diaz * diazN, phytoN)
    rs2n_zoo_fallback = (p.Rs2n_diat + p.Rs2n_cocco + p.Rs2n_cyano
                         + p.Rs2n_eukar + p.Rs2n_diaz
                         + p.Rs2n_phaeo) / 6.0
    rs2n_zoo = jnp.where(phytoN > 0.0, rs2n_zoo_weighted,
                         rs2n_zoo_fallback)
    zooS = rs2n_zoo * zooN

    # diagnosed bacteria (DMS_mod.F90:695)
    b_diagnosed = p.B_preexp * phytoN ** p.B_exp

    # kinetic terms (DMS_mod.F90:701-716)
    dms_s_dmsp = yield_ * p.k_conv * dmsp
    dms_s = dms_s_dmsp
    dms_r_B = p.k_S_B * b_diagnosed * dms
    dms_r_phot = j_dms * dms
    dms_r_bkgnd = p.k_bkgnd * dms
    dms_r = dms_r_B + dms_r_phot + dms_r_bkgnd

    dmsp_s_phaeo = p.inject_scale * p.k_S_p_base * phaeoS
    dmsp_s_nonphaeo = p.inject_scale * k_S_p * phytoS
    dmsp_s_zoo = p.inject_scale * p.k_S_z * zooS
    dmsp_s = dmsp_s_phaeo + dmsp_s_nonphaeo + dmsp_s_zoo
    dmsp_r_B = p.k_conv * dmsp
    dmsp_r_bkgnd = p.k_bkgnd * dmsp
    dmsp_r = dmsp_r_B + dmsp_r_bkgnd

    def masked(x):
        return jnp.where(active, x, 0.0)

    tend_dms = masked(dms_s - dms_r)
    tend_dmsp = masked(dmsp_s - dmsp_r)

    diags = {
        "DMS_S_DMSP": dms_s_dmsp, "DMS_S_TOTAL": dms_s,
        "DMS_R_B": dms_r_B, "DMS_R_PHOT": dms_r_phot,
        "DMS_R_BKGND": dms_r_bkgnd, "DMS_R_TOTAL": dms_r,
        "DMSP_S_PHAEO": dmsp_s_phaeo,
        "DMSP_S_NONPHAEO": dmsp_s_nonphaeo,
        "DMSP_S_ZOO": dmsp_s_zoo, "DMSP_S_TOTAL": dmsp_s,
        "DMSP_R_B": dmsp_r_B, "DMSP_R_BKGND": dmsp_r_bkgnd,
        "DMSP_R_TOTAL": dmsp_r,
        "Cyano_frac": jnp.broadcast_to(cyano_frac, dms.shape),
        "Cocco_frac": cocco_frac,
        "Eukar_frac": jnp.broadcast_to(eukar_frac, dms.shape),
        "diatS": diatS, "diatN": diatN, "phytoN": phytoN,
        "coccoS": coccoS, "cyanoS": cyanoS, "eukarS": eukarS,
        "diazS": diazS, "phaeoS": phaeoS, "zooS": zooS,
        "zooCC": zooC, "RSNzoo": rs2n_zoo,
    }
    if compute_uv:
        # UV: 1% of surface PAR, attenuated by DOC (DMS_mod.F90:509-510,
        # 531-536) — same closed-form exclusive cumprod as PAR above
        kuv_dz = (0.01e-2 * doc + 0.04e-4) * dz
        att_uv = jnp.exp(-kuv_dz)
        cum_uv = jnp.cumprod(att_uv, axis=0)
        uv_in = ((par_surf * 0.01)[None, :]
                 * jnp.concatenate([ones, cum_uv[:-1]], axis=0))
        diags["UV_in"] = uv_in
        diags["UV_out"] = uv_in * att_uv
        diags["UV_avg"] = uv_in * (1.0 - att_uv) / kuv_dz
    diags = {k: masked(v) for k, v in diags.items()}

    zero = jnp.zeros_like(tend_dms)
    tend = [zero] * DT.CNT
    tend[DT.DMS] = tend_dms
    tend[DT.DMSP] = tend_dmsp
    tendencies = jnp.stack(tend, axis=1)
    return tendencies, diags
