"""Surface gas-exchange fluxes vs scalar oracle + embedded check value."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.schmidt import o2sat
from ocean_bgc.ops.surface import bgc_surface_fluxes, dms_surface_fluxes
from ocean_bgc.params import BGCParams, DMSParams
from ocean_bgc.state import BGCForcing, BGCTracers as T
from tests.oracle import surface_ref as ref


def test_o2sat_check_value():
    """The reference's embedded check value (BGC_mod.F90:3028-3029):
    O2SAT(T=10 C, S=35 psu) = 282.015 mmol/m^3."""
    got = float(o2sat(jnp.asarray(10.0), jnp.asarray(35.0)))
    np.testing.assert_allclose(got, 282.015, atol=5e-4)


def _forcing(rng, nlev, ncol):
    return BGCForcing(
        potential_temperature=jnp.asarray(
            rng.uniform(-1.8, 31.0, (nlev, ncol))),
        salinity=jnp.asarray(rng.uniform(30.0, 38.0, (nlev, ncol))),
        dust_flux_in=jnp.asarray(rng.uniform(0.0, 1e-9, ncol)),
        shortwave_surface=jnp.asarray(rng.uniform(0.0, 350.0, ncol)),
        surface_pressure=jnp.asarray(rng.uniform(0.95, 1.05, ncol)),
        ice_fraction=jnp.asarray(rng.uniform(-0.2, 1.2, ncol)),
        wind_speed_squared_10m=jnp.asarray(rng.uniform(0.0, 4e6, ncol)),
        atm_co2=jnp.asarray(rng.uniform(280.0, 1200.0, ncol)),
        atm_co2_alt=jnp.asarray(rng.uniform(280.0, 600.0, ncol)),
        surface_depth=jnp.zeros(ncol),
        sst=jnp.asarray(rng.uniform(-1.8, 31.0, ncol)),
        sss=jnp.asarray(rng.uniform(30.0, 38.0, ncol)),
        fesedflux=jnp.zeros((nlev, ncol)),
        nutr_restore_rtau=jnp.zeros((nlev, ncol)),
        no3_clim=jnp.zeros((nlev, ncol)),
        po4_clim=jnp.zeros((nlev, ncol)),
        sio3_clim=jnp.zeros((nlev, ncol)),
        deposition_flux=jnp.asarray(
            rng.uniform(0.0, 1e-6, (T.CNT, ncol))),
        river_flux=jnp.asarray(rng.uniform(0.0, 1e-6, (T.CNT, ncol))),
        seaice_flux=jnp.asarray(rng.uniform(0.0, 1e-7, (T.CNT, ncol))),
        gas_flux=jnp.zeros((T.CNT, ncol)),
    )


def test_bgc_surface_fluxes_match_oracle(rng):
    nlev, ncol = 4, 24
    trc = rng.uniform(0.0, 3.0, (nlev, T.CNT, ncol))
    trc[:, T.DIC] = rng.uniform(1800.0, 2400.0, (nlev, ncol))
    trc[:, T.DIC_ALT_CO2] = rng.uniform(1800.0, 2400.0, (nlev, ncol))
    trc[:, T.ALK] = rng.uniform(2000.0, 2500.0, (nlev, ncol))
    trc[:, T.O2] = rng.uniform(0.0, 350.0, (nlev, ncol))
    forcing = _forcing(rng, nlev, ncol)
    params = BGCParams(parm_Fe_bioavail=0.7)

    surface_ph = np.zeros(ncol)
    surface_ph[::2] = 8.1   # half warm-started
    out = bgc_surface_fluxes(jnp.asarray(trc), forcing,
                             jnp.asarray(surface_ph), jnp.zeros(ncol),
                             params)
    net = np.asarray(out.net_flux)
    dep = np.asarray(forcing.deposition_flux)
    riv = np.asarray(forcing.river_flux)
    sei = np.asarray(forcing.seaice_flux)

    for col in range(ncol):
        want = ref.bgc_surface_column(
            trc[0, T.DIC, col], trc[0, T.DIC_ALT_CO2, col],
            trc[0, T.ALK, col], trc[0, T.PO4, col], trc[0, T.SIO3, col],
            trc[0, T.O2, col],
            float(forcing.sst[col]), float(forcing.sss[col]),
            float(forcing.surface_pressure[col]),
            float(forcing.ice_fraction[col]),
            float(forcing.wind_speed_squared_10m[col]),
            float(forcing.atm_co2[col]), float(forcing.atm_co2_alt[col]),
            0.0, surface_ph[col], 0.0)
        base = dep[:, col] + riv[:, col] + sei[:, col]
        np.testing.assert_allclose(
            net[T.O2, col], base[T.O2] + want["flux_o2"], rtol=1e-10)
        # dco2star is a small difference of similar numbers, so the pH
        # solver tolerance shows up amplified in *relative* terms; bound
        # absolutely by the piston velocity times the co2star error scale
        co2_atol = abs(want["pv_co2"]) * 1e-3 + 1e-12
        np.testing.assert_allclose(
            net[T.DIC, col], base[T.DIC] + want["flux_co2"],
            rtol=5e-4, atol=co2_atol)
        np.testing.assert_allclose(
            net[T.DIC_ALT_CO2, col],
            base[T.DIC_ALT_CO2] + want["flux_co2_alt"],
            rtol=5e-4, atol=co2_atol)
        # Fe bioavailability scaling
        np.testing.assert_allclose(
            net[T.FE, col], 0.7 * base[T.FE], rtol=1e-12)
        # alkalinity adjustment
        np.testing.assert_allclose(
            net[T.ALK, col],
            base[T.ALK] + net[T.NH4, col] - net[T.NO3, col], rtol=1e-12)
        h_got = 10.0 ** (-np.asarray(out.surface_ph)[col])
        h_want = 10.0 ** (-want["ph"])
        np.testing.assert_allclose(h_got, h_want, rtol=2e-5, atol=2e-10)


def test_dms_surface_fluxes_match_oracle(rng):
    ncol = 64
    dms = rng.uniform(0.0, 0.02, ncol)
    sst = rng.uniform(-1.8, 31.0, ncol)
    sss = rng.uniform(30.0, 38.0, ncol)
    ice = rng.uniform(-0.1, 1.1, ncol)
    # cover all three wind regimes: <3.6, blend, >5.6 m/s
    wind2 = np.concatenate([
        rng.uniform(0.0, 3.5e2**2, ncol // 2),
        rng.uniform(3.7e2**2, 5.5e2**2, ncol // 4),
        rng.uniform(6.0e2**2, 20.0e2**2, ncol - ncol // 2 - ncol // 4)])
    press = rng.uniform(0.95, 1.05, ncol)

    out = dms_surface_fluxes(jnp.asarray(dms), jnp.asarray(sst),
                             jnp.asarray(sss), jnp.asarray(ice),
                             jnp.asarray(wind2), jnp.asarray(press),
                             DMSParams())
    got = np.asarray(out.dms_flux)
    for col in range(ncol):
        want = ref.dms_surface_column(dms[col], sst[col], sss[col],
                                      ice[col], wind2[col], press[col])
        np.testing.assert_allclose(got[col], want, rtol=1e-12, atol=1e-22)
    assert (np.asarray(out.dmsp_flux) == 0.0).all()
