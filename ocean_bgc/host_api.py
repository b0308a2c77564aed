"""Drop-in host-coupling API: the reference's 9 public entry points.

A host ocean model coupled to the reference library calls (SURVEY.md par.1)::

    BGC_parms_init / BGC_init          DMS_parms_init / DMS_init
    MACROS_parms_init / MACROS_init
    BGC_SourceSink   BGC_SurfaceFluxes
    DMS_SourceSink   DMS_SurfaceFluxes
    MACROS_SourceSink

This module exposes those same operations with host-friendly conventions —
NumPy arrays in the host's column-major layout ``(column, level[, tracer])``,
tracer columns in this package's canonical order — marshaling through
``io.host_layout`` (the native C++ packer) and dispatching to the jitted
kernels.  State that the reference carries *in* its argument structs (the
pH warm starts) is passed in and returned explicitly.

**Tracer order: canonical inside, host-configurable at the boundary.**
The reference lets the host assign arbitrary tracer indices into its
``*_indices_type`` structs at init (BGC_parms.F90:81-125) and indexes
through that indirection on every access.  This framework deliberately
replaces the per-access indirection with the static canonical order of
``state.BGCTracers`` / ``DMSTracers`` / ``MACROSTracers`` (static
indices are what let XLA fuse the tracer block; a runtime permutation
inside the kernel would defeat it).  The indirection survives at the
*boundary*: every entry point takes an optional ``indices`` mapping
(canonical short name -> position in the HOST's tracer axis, the direct
analogue of filling ``BGC_indices_type``).  When given, arrays are
permuted host->canonical once on ingest and canonical->host once on
egress — O(bytes) against a kernel that is O(levels x solver iterations)
— and the mapping is validated as a complete bijection, so a wrong or
partial host order is an *error*, never silent wrong physics.  Without
``indices`` the host must already store tracers in canonical order
(``bgc_init().short_name`` gives the exact order).

Functions are stateless and jit-cached per shape; a production host that
controls its own device buffers should use the pytree API
(``models.coupled``) directly — this adapter is the migration path.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ocean_bgc.io import host_layout as hl
from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.ops.dms import dms_source_sink
from ocean_bgc.ops.macros import macros_source_sink
from ocean_bgc.ops.surface import bgc_surface_fluxes, dms_surface_fluxes
from ocean_bgc.params import (
    BGCParams,
    DMSParams,
    MACROSParams,
    default_autotrophs,
)
from ocean_bgc.state import (
    BGC_TRACER_NAMES,
    BGC_TRACER_LONG_NAMES,
    BGCForcing,
    BGCTracers,
    ColumnGrid,
    DMS_TRACER_NAMES,
    DMS_TRACER_LONG_NAMES,
    MACROS_TRACER_NAMES,
    MACROS_TRACER_LONG_NAMES,
    bgc_tracer_units,
)

BGC_tracer_cnt = BGCTracers.CNT        # 30 (BGC_mod.F90:117-118)
DMS_tracer_cnt = 14                    # DMS_mod.F90:61-62
MACROS_tracer_cnt = 8                  # MACROS_mod.F90:60-61


class TracerMetadata(NamedTuple):
    short_name: Tuple[str, ...]
    long_name: Tuple[str, ...]
    units: Tuple[str, ...]


def tracer_permutation(indices, names) -> np.ndarray:
    """Validate a host tracer-index mapping and return the ingest
    permutation.

    ``indices`` maps each canonical short name in ``names`` to its
    0-based position in the host's tracer axis — the analogue of the
    host filling ``BGC_indices_type`` / ``DMS_indices_type`` /
    ``MACROS_indices_type`` at init (BGC_parms.F90:81-125,
    DMS_parms.F90:62-83, MACROS_parms.F90:62-77; 0-based here because
    the arrays are NumPy).  The mapping must be a complete bijection:
    every canonical tracer named exactly once, positions a permutation
    of ``range(len(names))``.  Returns ``perm`` with
    ``canonical[..., c] == host[..., perm[c]]``; invert with
    ``np.argsort(perm)`` for egress.
    """
    names = tuple(names)
    extra = set(indices) - set(names)
    missing = set(names) - set(indices)
    if extra or missing:
        raise ValueError(
            f"tracer index map must cover exactly the canonical set: "
            f"missing={sorted(missing)} unknown={sorted(extra)}")
    perm = np.asarray([int(indices[n]) for n in names])
    if sorted(perm.tolist()) != list(range(len(names))):
        raise ValueError(
            f"tracer index positions must be a permutation of "
            f"0..{len(names) - 1}, got {perm.tolist()}")
    return perm


def _ingest_perm(indices, names):
    """(perm, inverse-perm) or (None, None) when no mapping is given."""
    if indices is None:
        return None, None
    perm = tracer_permutation(indices, names)
    return perm, np.argsort(perm)


def bgc_parms_init(**overrides) -> BGCParams:
    """Default parameter set (BGC_parms_init, BGC_parms.F90:497-699)."""
    return BGCParams(**overrides)


def bgc_init() -> TracerMetadata:
    """Tracer metadata registration (BGC_init, BGC_mod.F90:184-333)."""
    return TracerMetadata(BGC_TRACER_NAMES, BGC_TRACER_LONG_NAMES,
                          bgc_tracer_units())


def dms_parms_init(**overrides) -> DMSParams:
    return DMSParams(**overrides)


def dms_init() -> TracerMetadata:
    """Sulfur-tracer metadata registration (DMS_init,
    DMS_mod.F90:101-144): the reference's long names verbatim and its
    blanket 'mmol/m^3' units (DMS_mod.F90:144)."""
    return TracerMetadata(DMS_TRACER_NAMES, DMS_TRACER_LONG_NAMES,
                          ("mmol/m^3",) * DMS_tracer_cnt)


def macros_parms_init(**overrides) -> MACROSParams:
    return MACROSParams(**overrides)


def macros_init() -> TracerMetadata:
    """Macromolecule-tracer metadata registration (MACROS_init,
    MACROS_mod.F90:100-126; blanket units MACROS_mod.F90:126)."""
    return TracerMetadata(MACROS_TRACER_NAMES, MACROS_TRACER_LONG_NAMES,
                          ("mmol/m^3",) * MACROS_tracer_cnt)


def _grid_from_host(cell_center_depth, cell_thickness, cell_bottom_depth,
                    latitude, number_of_active_levels) -> ColumnGrid:
    return ColumnGrid(
        cell_center_depth=jnp.asarray(hl.to_level_major(cell_center_depth)),
        cell_thickness=jnp.asarray(hl.to_level_major(cell_thickness)),
        cell_bottom_depth=jnp.asarray(hl.to_level_major(cell_bottom_depth)),
        latitude=jnp.asarray(latitude, jnp.float64),
        kmax=jnp.asarray(number_of_active_levels, jnp.int32),
    )


@partial(jax.jit, static_argnames=("params", "diag_names"))
def _bgc_ss_jit(tracers, grid, forcing, ph_prev, ph_prev_alt, params,
                diag_names=None):
    out = bgc_source_sink(tracers, grid, forcing, ph_prev, ph_prev_alt,
                          params, compute_diags=True)
    if diag_names is not None:
        # selecting inside the jit lets XLA dead-code-eliminate the
        # unrequested diagnostics' computation and HBM writes (the
        # selective-diagnostics production configuration; see
        # models/coupled.py::evaluate_tendencies)
        unknown = set(diag_names) - set(out.diags)
        if unknown:
            raise KeyError(
                f"unknown diagnostics {sorted(unknown)}; valid names: "
                f"{sorted(out.diags)}")
        import dataclasses as _dc
        out = _dc.replace(
            out, diags={k: out.diags[k] for k in diag_names})
    return out


def BGC_SourceSink(
    *,
    BGC_tracers: np.ndarray,            # (ncol, nlev, 30) host layout
    PotentialTemperature: np.ndarray,   # (ncol, nlev)
    Salinity: np.ndarray,               # (ncol, nlev)
    cell_center_depth: np.ndarray,      # (ncol, nlev) cm
    cell_thickness: np.ndarray,         # (ncol, nlev) cm
    cell_bottom_depth: np.ndarray,      # (ncol, nlev) cm
    cell_latitude: np.ndarray,          # (ncol,)
    number_of_active_levels: np.ndarray,  # (ncol,)
    dust_FLUX_IN: np.ndarray,           # (ncol,)
    ShortWaveFlux_surface: np.ndarray,  # (ncol,)
    FESEDFLUX: Optional[np.ndarray] = None,        # (ncol, nlev)
    NUTR_RESTORE_RTAU: Optional[np.ndarray] = None,
    NO3_CLIM: Optional[np.ndarray] = None,
    PO4_CLIM: Optional[np.ndarray] = None,
    SiO3_CLIM: Optional[np.ndarray] = None,
    PH_PREV_3D: Optional[np.ndarray] = None,       # (ncol, nlev)
    PH_PREV_ALT_CO2_3D: Optional[np.ndarray] = None,
    params: Optional[BGCParams] = None,
    indices: Optional[Dict[str, int]] = None,
    diag_names: Optional[Tuple[str, ...]] = None,
) -> Dict[str, np.ndarray]:
    """Ecosystem tendencies (BGC_SourceSink, BGC_mod.F90:340-1998).

    Returns {"BGC_tendencies": (ncol, nlev, 30), "PH_PREV_3D": ...,
    "PH_PREV_ALT_CO2_3D": ..., "diags": {...}} in host layout.
    ``indices``: optional host tracer-order map (see module docstring);
    tendencies come back in the host's order.
    ``diag_names``: optionally emit only these diagnostics — the rest
    are dead-code-eliminated from the compiled kernel (the reference
    always computes all ~95, but its host writes only what it asked
    for).
    Returned values agree with the full run to refusion ulps (pruning
    outputs changes XLA's fusion choices).
    """
    params = params or BGCParams()
    perm, inv = _ingest_perm(indices, BGC_TRACER_NAMES)
    if perm is not None:
        BGC_tracers = BGC_tracers[..., perm]
    ncol, nlev = PotentialTemperature.shape
    z2 = lambda: jnp.zeros((nlev, ncol))  # noqa: E731

    grid = _grid_from_host(cell_center_depth, cell_thickness,
                           cell_bottom_depth, cell_latitude,
                           number_of_active_levels)
    forcing = BGCForcing(
        potential_temperature=jnp.asarray(
            hl.to_level_major(PotentialTemperature)),
        salinity=jnp.asarray(hl.to_level_major(Salinity)),
        dust_flux_in=jnp.asarray(dust_FLUX_IN, jnp.float64),
        shortwave_surface=jnp.asarray(ShortWaveFlux_surface, jnp.float64),
        surface_pressure=jnp.ones(ncol), ice_fraction=jnp.zeros(ncol),
        wind_speed_squared_10m=jnp.zeros(ncol),
        atm_co2=jnp.zeros(ncol), atm_co2_alt=jnp.zeros(ncol),
        surface_depth=jnp.zeros(ncol), sst=jnp.zeros(ncol),
        sss=jnp.zeros(ncol),
        fesedflux=(jnp.asarray(hl.to_level_major(FESEDFLUX))
                   if FESEDFLUX is not None else z2()),
        nutr_restore_rtau=(jnp.asarray(hl.to_level_major(NUTR_RESTORE_RTAU))
                           if NUTR_RESTORE_RTAU is not None else z2()),
        no3_clim=(jnp.asarray(hl.to_level_major(NO3_CLIM))
                  if NO3_CLIM is not None else z2()),
        po4_clim=(jnp.asarray(hl.to_level_major(PO4_CLIM))
                  if PO4_CLIM is not None else z2()),
        sio3_clim=(jnp.asarray(hl.to_level_major(SiO3_CLIM))
                   if SiO3_CLIM is not None else z2()),
        deposition_flux=jnp.zeros((BGC_tracer_cnt, ncol)),
        river_flux=jnp.zeros((BGC_tracer_cnt, ncol)),
        seaice_flux=jnp.zeros((BGC_tracer_cnt, ncol)),
        gas_flux=jnp.zeros((BGC_tracer_cnt, ncol)),
    )
    tr = jnp.asarray(hl.pack_tracer_block(BGC_tracers))
    ph = (jnp.asarray(hl.to_level_major(PH_PREV_3D))
          if PH_PREV_3D is not None else z2())
    ph_alt = (jnp.asarray(hl.to_level_major(PH_PREV_ALT_CO2_3D))
              if PH_PREV_ALT_CO2_3D is not None else z2())

    out = _bgc_ss_jit(tr, grid, forcing, ph, ph_alt, params,
                      diag_names=(tuple(diag_names)
                                  if diag_names is not None else None))
    tend = hl.unpack_tracer_block(np.asarray(out.tendencies))
    if inv is not None:
        tend = np.ascontiguousarray(tend[..., inv])
    return {
        "BGC_tendencies": tend,
        "PH_PREV_3D": hl.from_level_major(np.asarray(out.ph_prev_3d)),
        "PH_PREV_ALT_CO2_3D": hl.from_level_major(
            np.asarray(out.ph_prev_alt_3d)),
        "diags": {k: np.asarray(v) for k, v in out.diags.items()},
    }


@partial(jax.jit, static_argnames=("params",))
def _bgc_sf_jit(tracers, forcing, sph, spha, params):
    return bgc_surface_fluxes(tracers, forcing, sph, spha, params)


def BGC_SurfaceFluxes(
    *,
    BGC_tracers: np.ndarray,            # (ncol, nlev, 30)
    SST: np.ndarray, SSS: np.ndarray,
    surfacePressure: np.ndarray, iceFraction: np.ndarray,
    windSpeedSquared10m: np.ndarray,
    atmCO2: np.ndarray, atmCO2_ALT_CO2: np.ndarray,
    surfaceDepth: np.ndarray,
    surface_pH: Optional[np.ndarray] = None,
    surface_pH_alt_co2: Optional[np.ndarray] = None,
    depositionFlux: Optional[np.ndarray] = None,   # (ncol, 30)
    riverFlux: Optional[np.ndarray] = None,
    gasFlux: Optional[np.ndarray] = None,
    seaIceFlux: Optional[np.ndarray] = None,
    params: Optional[BGCParams] = None,
    indices: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Air-sea fluxes (BGC_SurfaceFluxes, BGC_mod.F90:2706-2957).
    Returns {"netFlux": (ncol, 30), "surface_pH": ..., "diags": ...};
    per-tracer inputs and netFlux follow ``indices`` when given."""
    params = params or BGCParams()
    perm, inv = _ingest_perm(indices, BGC_TRACER_NAMES)
    if perm is not None:
        BGC_tracers = BGC_tracers[..., perm]
        depositionFlux, riverFlux, gasFlux, seaIceFlux = (
            a if a is None else a[..., perm]
            for a in (depositionFlux, riverFlux, gasFlux, seaIceFlux))
    ncol, nlev = BGC_tracers.shape[0], BGC_tracers.shape[1]
    zt = lambda a: (jnp.asarray(np.ascontiguousarray(a.T))  # noqa: E731
                    if a is not None
                    else jnp.zeros((BGC_tracer_cnt, ncol)))
    forcing = BGCForcing(
        potential_temperature=jnp.zeros((nlev, ncol)),
        salinity=jnp.zeros((nlev, ncol)),
        dust_flux_in=jnp.zeros(ncol),
        shortwave_surface=jnp.zeros(ncol),
        surface_pressure=jnp.asarray(surfacePressure, jnp.float64),
        ice_fraction=jnp.asarray(iceFraction, jnp.float64),
        wind_speed_squared_10m=jnp.asarray(windSpeedSquared10m,
                                           jnp.float64),
        atm_co2=jnp.asarray(atmCO2, jnp.float64),
        atm_co2_alt=jnp.asarray(atmCO2_ALT_CO2, jnp.float64),
        surface_depth=jnp.asarray(surfaceDepth, jnp.float64),
        sst=jnp.asarray(SST, jnp.float64),
        sss=jnp.asarray(SSS, jnp.float64),
        fesedflux=jnp.zeros((nlev, ncol)),
        nutr_restore_rtau=jnp.zeros((nlev, ncol)),
        no3_clim=jnp.zeros((nlev, ncol)),
        po4_clim=jnp.zeros((nlev, ncol)),
        sio3_clim=jnp.zeros((nlev, ncol)),
        deposition_flux=zt(depositionFlux), river_flux=zt(riverFlux),
        seaice_flux=zt(seaIceFlux), gas_flux=zt(gasFlux),
    )
    tr = jnp.asarray(hl.pack_tracer_block(BGC_tracers))
    sph = (jnp.asarray(surface_pH, jnp.float64)
           if surface_pH is not None else jnp.zeros(ncol))
    spha = (jnp.asarray(surface_pH_alt_co2, jnp.float64)
            if surface_pH_alt_co2 is not None else jnp.zeros(ncol))
    out = _bgc_sf_jit(tr, forcing, sph, spha, params)
    net = np.ascontiguousarray(np.asarray(out.net_flux).T)
    if inv is not None:
        net = np.ascontiguousarray(net[..., inv])
    return {
        "netFlux": net,
        "surface_pH": np.asarray(out.surface_ph),
        "surface_pH_alt_co2": np.asarray(out.surface_ph_alt),
        "diags": {k: np.asarray(v) for k, v in out.diags.items()},
    }


@partial(jax.jit, static_argnames=("params",))
def _dms_ss_jit(tracers, dz, active, sst, sw, params):
    return dms_source_sink(tracers, dz, active, sst, sw, params)


def DMS_SourceSink(
    *,
    DMS_tracers: np.ndarray,          # (ncol, nlev, 14)
    cell_thickness: np.ndarray,       # (ncol, nlev) cm
    number_of_active_levels: np.ndarray,
    SST: np.ndarray,
    ShortWaveFlux_surface: np.ndarray,
    params: Optional[DMSParams] = None,
    indices: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Sulfur-cycle tendencies (DMS_SourceSink, DMS_mod.F90:156-770)."""
    params = params or DMSParams()
    perm, inv = _ingest_perm(indices, DMS_TRACER_NAMES)
    if perm is not None:
        DMS_tracers = DMS_tracers[..., perm]
    nlev = DMS_tracers.shape[1]
    kmax = jnp.asarray(number_of_active_levels, jnp.int32)
    active = jnp.arange(nlev, dtype=jnp.int32)[:, None] < kmax[None, :]
    tend, diags = _dms_ss_jit(
        jnp.asarray(hl.pack_tracer_block(DMS_tracers)),
        jnp.asarray(hl.to_level_major(cell_thickness)), active,
        jnp.asarray(SST, jnp.float64),
        jnp.asarray(ShortWaveFlux_surface, jnp.float64), params)
    tout = hl.unpack_tracer_block(np.asarray(tend))
    if inv is not None:
        tout = np.ascontiguousarray(tout[..., inv])
    return {
        "DMS_tendencies": tout,
        "diags": {k: np.asarray(v) for k, v in diags.items()},
    }


@partial(jax.jit, static_argnames=("params",))
def _dms_sf_jit(dms_surf, sst, sss, ice, wind2, press, params):
    return dms_surface_fluxes(dms_surf, sst, sss, ice, wind2, press,
                              params)


def DMS_SurfaceFluxes(
    *,
    DMS_tracers: np.ndarray,          # (ncol, nlev, 14)
    SST: np.ndarray, SSS: np.ndarray,
    iceFraction: np.ndarray, windSpeedSquared10m: np.ndarray,
    surfacePressure: np.ndarray,
    params: Optional[DMSParams] = None,
    indices: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """DMS gas flux (DMS_SurfaceFluxes, DMS_mod.F90:778-908).  Returns
    netFlux rows for dms/dmsp plus the 8 flux diagnostics."""
    params = params or DMSParams()
    perm, _ = _ingest_perm(indices, DMS_TRACER_NAMES)
    dms_pos = int(perm[0]) if perm is not None else 0  # canonical 0 = dms
    out = _dms_sf_jit(
        jnp.asarray(DMS_tracers[:, 0, dms_pos], jnp.float64),
        jnp.asarray(SST, jnp.float64), jnp.asarray(SSS, jnp.float64),
        jnp.asarray(iceFraction, jnp.float64),
        jnp.asarray(windSpeedSquared10m, jnp.float64),
        jnp.asarray(surfacePressure, jnp.float64), params)
    return {
        "netFlux_dms": np.asarray(out.dms_flux),
        "netFlux_dmsp": np.asarray(out.dmsp_flux),
        "diags": {k: np.asarray(v) for k, v in out.diags.items()},
    }


@partial(jax.jit, static_argnames=("params",))
def _mac_ss_jit(tracers, active, params):
    return macros_source_sink(tracers, active, params)


def MACROS_SourceSink(
    *,
    MACROS_tracers: np.ndarray,       # (ncol, nlev, 8)
    number_of_active_levels: np.ndarray,
    params: Optional[MACROSParams] = None,
    indices: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Macromolecule tendencies (MACROS_SourceSink, MACROS_mod.F90:137-411)."""
    params = params or MACROSParams()
    perm, inv = _ingest_perm(indices, MACROS_TRACER_NAMES)
    if perm is not None:
        MACROS_tracers = MACROS_tracers[..., perm]
    nlev = MACROS_tracers.shape[1]
    kmax = jnp.asarray(number_of_active_levels, jnp.int32)
    active = jnp.arange(nlev, dtype=jnp.int32)[:, None] < kmax[None, :]
    tend, diags = _mac_ss_jit(
        jnp.asarray(hl.pack_tracer_block(MACROS_tracers)), active, params)
    tout = hl.unpack_tracer_block(np.asarray(tend))
    if inv is not None:
        tout = np.ascontiguousarray(tout[..., inv])
    return {
        "MACROS_tendencies": tout,
        "diags": {k: np.asarray(v) for k, v in diags.items()},
    }
