"""Synthetic ocean-world generator: plausible grids, hydrography, tracers.

Builds a deterministic idealized global column set (latitude-dependent
hydrography, exponential biology profiles, ragged shelf/deep bathymetry)
for tests, benchmarks, and the compile-check entry points.  Values sit in
the middle of observed ocean ranges so every kernel branch is exercised
without pathological inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax.numpy as jnp

from ocean_bgc.models.coupled import CoupledState
from ocean_bgc.state import (
    BGCForcing,
    BGCState,
    BGCTracers as T,
    ColumnGrid,
)


def synthetic_world(
    nlev: int = 60,
    ncol: int = 1024,
    seed: int = 0,
    ragged: bool = True,
    dtype=None,
) -> Tuple[CoupledState, ColumnGrid, BGCForcing]:
    """``dtype=jnp.float32`` builds the world in single precision — the
    opt-in fast path (the kernels are dtype-polymorphic; the f64 default
    is the reference contract)."""
    rng = np.random.default_rng(seed)

    # geometry: 60 levels, 10 m cells near surface thickening to ~250 m
    dz1 = np.geomspace(1000.0, 25000.0, nlev)           # cm
    dz = np.tile(dz1[:, None], (1, ncol))
    zbot = np.cumsum(dz, axis=0)
    zcen = zbot - 0.5 * dz

    lat = np.linspace(-75.0, 75.0, ncol)
    if ragged:
        kmax = np.full(ncol, nlev, dtype=np.int32)
        shelf = rng.random(ncol) < 0.15                  # 15% shelf columns
        kmax[shelf] = rng.integers(min(5, nlev), nlev + 1, shelf.sum())
        land = rng.random(ncol) < 0.02                   # 2% land
        kmax[land] = 0
    else:
        kmax = np.full(ncol, nlev, dtype=np.int32)

    grid = ColumnGrid(
        cell_center_depth=jnp.asarray(zcen),
        cell_thickness=jnp.asarray(dz),
        cell_bottom_depth=jnp.asarray(zbot),
        latitude=jnp.asarray(lat),
        kmax=jnp.asarray(kmax),
    )

    # hydrography: warm tropics, cold poles, cooling with depth
    sst = 28.0 * np.cos(np.deg2rad(lat)) ** 2 - 1.0
    temp = (sst[None, :] - (sst[None, :] - 2.0)
            * (1.0 - np.exp(-zcen / 80000.0)))
    salt = 34.0 + 1.5 * np.exp(-zcen / 50000.0) * np.cos(np.deg2rad(lat))

    depth_frac = zcen / zcen.max()
    surf_bio = np.exp(-zcen / 8000.0)                    # e-fold 80 m

    trc = np.zeros((nlev, T.CNT, ncol))
    trc[:, T.PO4] = 0.3 + 2.2 * depth_frac
    trc[:, T.NO3] = 4.0 + 28.0 * depth_frac
    trc[:, T.SIO3] = 3.0 + 120.0 * depth_frac
    trc[:, T.NH4] = 0.1 * surf_bio
    trc[:, T.FE] = 2e-4 + 5e-4 * depth_frac
    trc[:, T.O2] = 320.0 - 150.0 * np.exp(-(depth_frac - 0.15) ** 2 / 0.02)
    trc[:, T.DIC] = 1950.0 + 350.0 * depth_frac
    trc[:, T.DIC_ALT_CO2] = trc[:, T.DIC]
    trc[:, T.ALK] = 2300.0 + 100.0 * depth_frac
    trc[:, T.DOC] = 38.0 * surf_bio + 2.0
    trc[:, T.DON] = 2.5 * surf_bio + 0.2
    trc[:, T.DOFE] = 2e-5 * surf_bio
    trc[:, T.DOP] = 0.15 * surf_bio + 0.02
    trc[:, T.DOPR] = 0.03
    trc[:, T.DONR] = 1.2
    trc[:, T.ZOOC] = 0.6 * surf_bio
    bloom = 0.5 + 0.5 * np.cos(np.deg2rad(lat))[None, :]
    for g, amp in zip(range(4), (1.2, 1.0, 0.15, 0.4)):
        trc[:, T.CHL_IND[g]] = 0.25 * amp * bloom * surf_bio
        trc[:, T.C_IND[g]] = 1.5 * amp * bloom * surf_bio
        trc[:, T.FE_IND[g]] = 6e-6 * amp * bloom * surf_bio
    trc[:, T.DIATSI] = 0.3 * bloom * surf_bio
    trc[:, T.SPCACO3] = 0.08 * bloom * surf_bio

    forcing = BGCForcing(
        potential_temperature=jnp.asarray(temp),
        salinity=jnp.asarray(salt),
        dust_flux_in=jnp.asarray(1e-10 * (1.2 + np.sin(np.deg2rad(lat)))),
        shortwave_surface=jnp.asarray(
            320.0 * np.maximum(np.cos(np.deg2rad(lat)), 0.05)),
        surface_pressure=jnp.asarray(np.full(ncol, 1.0)),
        ice_fraction=jnp.asarray(
            np.clip((np.abs(lat) - 65.0) / 10.0, 0.0, 0.9)),
        wind_speed_squared_10m=jnp.asarray(
            (600.0 + 700.0 * np.abs(np.sin(np.deg2rad(lat)))) ** 2),
        atm_co2=jnp.asarray(np.full(ncol, 415.0)),
        atm_co2_alt=jnp.asarray(np.full(ncol, 284.0)),
        surface_depth=jnp.zeros(ncol),
        sst=jnp.asarray(temp[0]),
        sss=jnp.asarray(salt[0]),
        fesedflux=jnp.asarray(
            1e-9 * np.exp(-(zbot - zbot[-1:]) ** 2 / 1e10)),
        nutr_restore_rtau=jnp.zeros((nlev, ncol)),
        no3_clim=jnp.asarray(trc[:, T.NO3].copy()),
        po4_clim=jnp.asarray(trc[:, T.PO4].copy()),
        sio3_clim=jnp.asarray(trc[:, T.SIO3].copy()),
        deposition_flux=jnp.zeros((T.CNT, ncol)),
        river_flux=jnp.zeros((T.CNT, ncol)),
        seaice_flux=jnp.zeros((T.CNT, ncol)),
        gas_flux=jnp.zeros((T.CNT, ncol)),
    )

    state = CoupledState(
        bgc=BGCState(
            tracers=jnp.asarray(trc),
            ph_prev_3d=jnp.zeros((nlev, ncol)),
            ph_prev_alt_3d=jnp.zeros((nlev, ncol)),
            surface_ph=jnp.zeros(ncol),
            surface_ph_alt=jnp.zeros(ncol),
        ),
        dms=jnp.asarray(
            np.stack([np.full((nlev, ncol), 3e-3) * surf_bio,
                      np.full((nlev, ncol), 1e-2) * surf_bio], axis=1)),
        macros=jnp.asarray(
            np.stack([np.full((nlev, ncol), 1.0) * surf_bio,
                      np.full((nlev, ncol), 0.5) * surf_bio,
                      np.full((nlev, ncol), 0.1) * surf_bio], axis=1)),
    )
    if dtype is not None:
        import jax

        def cast(tree):
            return jax.tree.map(
                lambda x: x.astype(dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)

        state, grid, forcing = cast(state), cast(grid), cast(forcing)
    return state, grid, forcing
