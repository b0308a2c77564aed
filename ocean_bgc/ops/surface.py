"""Air-sea surface fluxes for the BGC and DMS tracer families.

Re-design of ``BGC_SurfaceFluxes`` (BGC_mod.F90:2706-2957) and
``DMS_SurfaceFluxes`` (DMS_mod.F90:778-908): column-batched, fully
vectorized (one lane per column), functional — the reference mutates its
forcing arrays in place; here scaled/derived fluxes are returned.

Flux sign/unit convention follows the reference: gas flux =
pistonVel(cm/s) * concentration difference (mmol/m^3), positive into the
ocean; the host (our coupled step) divides by the top-cell thickness.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ocean_bgc.constants import (
    DEL_PH,
    PHHI_SURF_INIT,
    PHLO_SURF_INIT,
    XKW_COEFF,
)
from ocean_bgc.ops.carbonate import co2calc_surface_dual
from ocean_bgc.ops.schmidt import (
    dmssat,
    o2sat,
    schmidt_co2,
    schmidt_dms,
    schmidt_o2,
)
from ocean_bgc.params import BGCParams, DMSParams
from ocean_bgc.state import BGCForcing, BGCTracers as T


class BGCSurfaceOut(NamedTuple):
    net_flux: jax.Array          # (30, ncol) total surface flux per tracer
    surface_ph: jax.Array        # (ncol,) updated warm-start state
    surface_ph_alt: jax.Array    # (ncol,)
    diags: Dict[str, jax.Array]  # the 14 flux diagnostics


def bgc_surface_fluxes(
    tracers: jax.Array,          # (nlev, 30, ncol)
    forcing: BGCForcing,
    surface_ph: jax.Array,       # (ncol,) 0 sentinel = cold start
    surface_ph_alt: jax.Array,
    params: BGCParams,
) -> BGCSurfaceOut:
    """O2 and CO2 (ambient + alternative) gas exchange plus the
    deposition/river/sea-ice flux roll-up and the NH4-NO3 alkalinity
    adjustment (BGC_mod.F90:2808-2942)."""

    surf = jnp.maximum(tracers[0], 0.0)          # (30, ncol)
    dic = surf[T.DIC]
    dic_alt = surf[T.DIC_ALT_CO2]
    alk = surf[T.ALK]
    po4 = surf[T.PO4]
    sio3 = surf[T.SIO3]
    o2 = surf[T.O2]

    # bioavailable-iron scaling of the four flux channels
    # (BGC_mod.F90:2828-2835)
    fe_row = jnp.zeros(
        (T.CNT,),
        dtype=forcing.deposition_flux.dtype).at[T.FE].set(1.0)[:, None]
    scale = 1.0 + fe_row * (params.parm_Fe_bioavail - 1.0)
    deposition = forcing.deposition_flux * scale
    river = forcing.river_flux * scale
    seaice = forcing.seaice_flux * scale
    gas = forcing.gas_flux * scale

    ice = jnp.clip(forcing.ice_fraction, 0.0, 1.0)
    xkw = XKW_COEFF * forcing.wind_speed_squared_10m
    xkw_ice = (1.0 - ice) * xkw

    diags = {}

    # ---- O2 (BGC_mod.F90:2847-2860) ----
    if params.lcalc_O2_gas_flux:
        sc_o2 = schmidt_o2(forcing.sst)
        o2sat_1atm = o2sat(forcing.sst, forcing.sss)
        pv_o2 = xkw_ice * jnp.sqrt(660.0 / sc_o2)
        o2sat_loc = forcing.surface_pressure * o2sat_1atm
        gas = gas.at[T.O2].set(pv_o2 * (o2sat_loc - o2))
        diags.update({"pistonVel_O2": pv_o2, "SCHMIDT_O2": sc_o2,
                      "O2SAT": o2sat_loc, "xkw": xkw_ice})
    else:
        zero = jnp.zeros_like(xkw_ice)
        diags.update({"pistonVel_O2": zero, "SCHMIDT_O2": zero,
                      "O2SAT": zero, "xkw": zero})

    # ---- CO2, ambient + alternative scenario (BGC_mod.F90:2866-2923) ----
    if params.lcalc_CO2_gas_flux:
        sc_co2 = schmidt_co2(forcing.sst)
        pv_co2 = xkw_ice * jnp.sqrt(660.0 / sc_co2)

        # H-space warm brackets: one 10**-ph per column per scenario
        # instead of two (carbonate.py::warm_brackets_h; the reference
        # window is BGC_mod.F90:2872-2878)
        from ocean_bgc.ops.carbonate import (
            warm_brackets_h, x0_seed_enabled)
        seed = x0_seed_enabled()
        br = warm_brackets_h(surface_ph, PHLO_SURF_INIT, PHHI_SURF_INIT,
                             DEL_PH, with_seed=seed)
        br_alt = warm_brackets_h(surface_ph_alt, PHLO_SURF_INIT,
                                 PHHI_SURF_INIT, DEL_PH, with_seed=seed)
        ((ph_new, co2star, dco2star, pco2surf, dpco2),
         (ph_alt_new, co2star_alt, dco2star_alt, pco2surf_alt,
          dpco2_alt)) = co2calc_surface_dual(
            forcing.surface_depth, forcing.sst, forcing.sss,
            dic, dic_alt, alk, po4, sio3, None, None, None, None,
            forcing.atm_co2, forcing.atm_co2_alt, forcing.surface_pressure,
            locmip_k1_k2_bug_fix=params.locmip_k1_k2_bug_fix,
            brackets_a=br, brackets_b=br_alt,
            trusted_a=(surface_ph != 0.0).astype(dic.dtype),
            trusted_b=(surface_ph_alt != 0.0).astype(dic.dtype))
        gas = gas.at[T.DIC].set(pv_co2 * dco2star)
        gas = gas.at[T.DIC_ALT_CO2].set(pv_co2 * dco2star_alt)

        diags.update({
            "co2star": co2star, "dco2star": dco2star,
            "pco2surf": pco2surf, "dpco2": dpco2,
            "pistonVel_CO2": pv_co2, "SCHMIDT_CO2": sc_co2,
            "co2star_alt_co2": co2star_alt,
            "dco2star_alt_co2": dco2star_alt,
            "pco2surf_alt_co2": pco2surf_alt,
            "dpco2_alt_co2": dpco2_alt,
        })
    else:
        ph_new, ph_alt_new = surface_ph, surface_ph_alt
        zero = jnp.zeros_like(xkw_ice)
        diags.update({
            "co2star": zero, "dco2star": zero, "pco2surf": zero,
            "dpco2": zero, "pistonVel_CO2": zero, "SCHMIDT_CO2": zero,
            "co2star_alt_co2": zero, "dco2star_alt_co2": zero,
            "pco2surf_alt_co2": zero, "dpco2_alt_co2": zero,
        })

    # ---- net flux roll-up + alkalinity adjustment
    # (BGC_mod.F90:2929-2942) ----
    net = deposition + gas + river + seaice
    net = net.at[T.ALK].add(net[T.NH4] - net[T.NO3])

    return BGCSurfaceOut(net_flux=net, surface_ph=ph_new,
                         surface_ph_alt=ph_alt_new, diags=diags)


class DMSSurfaceOut(NamedTuple):
    dms_flux: jax.Array          # (ncol,) surface flux of DMS
    dmsp_flux: jax.Array         # (ncol,) identically zero
    diags: Dict[str, jax.Array]


def dms_surface_fluxes(
    dms_surf_tracer: jax.Array,   # (ncol,) surface DMS concentration
    sst: jax.Array,
    sss: jax.Array,
    ice_fraction: jax.Array,
    wind_speed_squared_10m: jax.Array,   # cm^2/s^2
    surface_pressure: jax.Array,
    params: DMSParams,
) -> DMSSurfaceOut:
    """Hybrid Wanninkhof-92 / Liss-Merlivat-86 DMS piston velocity with
    wind-speed blending over 3.6-5.6 m/s (DMS_mod.F90:852-899)."""

    dms_surf = jnp.maximum(dms_surf_tracer, 0.0)
    ice = jnp.clip(ice_fraction, 0.0, 1.0)
    sc = schmidt_dms(sst)
    wind = jnp.sqrt(jnp.abs(wind_speed_squared_10m)) * 0.01  # cm/s -> m/s

    a, e2, e3 = 0.31, 2.85, 0.612
    xkw_w92 = a * (660.0 / sc) ** 0.5 * wind * wind
    xkw_lm86 = (e2 * (600.0 / sc) ** 0.5 * (wind - 3.6)
                + e3 * (600.0 / sc) ** (0.667))

    f_lm86 = 0.5 * (wind - 3.6)
    xkw_blend = (1.0 - f_lm86) * xkw_w92 + f_lm86 * xkw_lm86
    xkw = jnp.where(wind < 3.6, xkw_w92,
                    jnp.where(wind < 5.6, xkw_blend, xkw_lm86))
    xkw = xkw / 3600.0                       # cm/hr -> cm/s
    xkw_ice = (1.0 - ice) * xkw

    dmssat_1atm = dmssat(sst, sss)
    pv = xkw_ice * jnp.sqrt(660.0 / sc)
    sat = surface_pressure * dmssat_1atm
    flux = jnp.where(params.lcalc_DMS_gas_flux,
                     pv * (sat - dms_surf), 0.0)

    diags = {
        "DMS_IFRAC": ice, "DMS_XKW": xkw_ice,
        "DMS_ATM_PRESS": surface_pressure, "DMS_PV": pv,
        "DMS_SCHMIDT": sc, "DMS_SAT": sat, "DMS_SURF": dms_surf,
        "DMS_WS": wind,
    }
    return DMSSurfaceOut(dms_flux=flux, dmsp_flux=jnp.zeros_like(flux),
                         diags=diags)
