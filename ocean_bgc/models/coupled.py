"""The coupled column model: BGC + DMS + MACROS over one shared tracer state.

The reference is a tendency library — the host ocean model owns time
stepping (SURVEY.md par.0).  This module is the framework's "host": a pure
``step(state, grid, forcing, params, dt)`` that

1. computes air-sea fluxes (BGC O2/CO2 + DMS), threading the surface-pH
   warm-start state (BGC_mod.F90:2872-2914),
2. evaluates all three source-sink kernels — the DMS/MACROS kernels read
   their ecosystem driver fields as views of the shared BGC tracer block
   (the host-side tracer aliasing of DMS_parms.F90:63-77,
   MACROS_parms.F90:62-71),
3. advances tracers forward-Euler, depositing surface fluxes into the top
   active cell,

and is a single jit/scan-able unit: ``run(state, ..., nsteps)`` compiles
the whole integration into one XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ocean_bgc.ops.bgc import (
    EnvCache,
    bgc_source_sink,
    precompute_env,
)
from ocean_bgc.ops.dms import dms_source_sink
from ocean_bgc.ops.macros import macros_source_sink
from ocean_bgc.ops.surface import bgc_surface_fluxes, dms_surface_fluxes
from ocean_bgc.params import ModelParams
from ocean_bgc.state import (
    BGCForcing,
    BGCState,
    BGCTracers as BT,
    ColumnGrid,
    DMSTracers as DT,
    MACROSTracers as MT,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoupledState:
    """Prognostic state of the coupled model: the 30 BGC tracers with their
    pH warm-start fields, plus DMS/DMSP and PROT/POLY/LIP."""

    bgc: BGCState
    dms: jax.Array        # (nlev, 2, ncol): DMS, DMSP
    macros: jax.Array     # (nlev, 3, ncol): PROT, POLY, LIP


def dms_tracer_block(state: CoupledState) -> jax.Array:
    """Assemble the 14-tracer DMS input block: 2 prognostic sulfur tracers
    + 12 read-only views of the ecosystem state."""
    b = state.bgc.tracers
    rows = [
        state.dms[:, 0], state.dms[:, 1],
        b[:, BT.NO3], b[:, BT.DOC], b[:, BT.ZOOC], b[:, BT.SPC],
        b[:, BT.SPCACO3], b[:, BT.DIATC], b[:, BT.DIAZC], b[:, BT.PHAEOC],
        b[:, BT.SPCHL], b[:, BT.DIATCHL], b[:, BT.DIAZCHL],
        b[:, BT.PHAEOCHL],
    ]
    return jnp.stack(rows, axis=1)


def macros_tracer_block(state: CoupledState) -> jax.Array:
    """Assemble the 8-tracer MACROS input block."""
    b = state.bgc.tracers
    rows = [
        state.macros[:, 0], state.macros[:, 1], state.macros[:, 2],
        b[:, BT.ZOOC], b[:, BT.SPC], b[:, BT.DIATC], b[:, BT.DIAZC],
        b[:, BT.PHAEOC],
    ]
    return jnp.stack(rows, axis=1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoupledTendencies:
    """Time derivatives of the prognostic fields (surface fluxes already
    deposited into the top active cell), plus the pH warm-start fields
    that the solve updated as a side effect."""

    bgc: jax.Array        # (nlev, 30, ncol)
    dms: jax.Array        # (nlev, 2, ncol)
    macros: jax.Array     # (nlev, 3, ncol)
    ph_prev_3d: jax.Array
    ph_prev_alt_3d: jax.Array
    surface_ph: jax.Array
    surface_ph_alt: jax.Array


def evaluate_tendencies(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    *,
    compute_diags: bool = True,
    carbonate_impl: str = "auto",
    diag_dtype=None,
    env: EnvCache = None,
    health: bool = False,
    diag_filter=None,
) -> Tuple[CoupledTendencies, Dict[str, jax.Array]]:
    """The coupled model's right-hand side: surface fluxes + all three
    source-sink kernels, as d(state)/dt pytrees.

    ``diag_filter``: optional sequence of diagnostic names — the
    returned dict carries exactly these (unknown names raise KeyError
    with the valid set).  A refinement of the reference's
    always-compute-everything diagnostics (SURVEY.md par.5): because
    only the RETURNED arrays survive XLA dead-code elimination, a
    production host that consumes a handful of history fields pays HBM
    writes (and any diag-only arithmetic) for just those, recovering
    most of the diags-off throughput.  Values agree with the
    unfiltered run's to refusion ulps (pruning outputs can change
    XLA's fusion choices; bitwise in the pinned CPU configuration,
    tests/test_coupled.py).

    ``health``: add two psum-able scalar counters to the returned
    diagnostics dict — ``health_solver_nonconverged_cells`` and
    ``health_poc_error_cells`` (ops/bgc.py::StepHealth) — emitted even
    with ``compute_diags=False``, so a production run can watch the
    reference's silent failure modes (co2calc.F90:993-995's
    fall-through, BGC_mod.F90:2296's write-only poc_error) at the cost
    of one residual evaluation per cell.

    ``diag_dtype``: optional dtype (e.g. ``jnp.float32``) the emitted
    diagnostics are cast to.  All diagnostic *arithmetic* stays in the
    state dtype; only the output arrays narrow — halving the ~155-field
    diagnostic HBM traffic, matching how production hosts write
    single-precision history files from a float64 model.  ``None``
    (default) emits diagnostics in the state dtype.
    """

    active = grid.active_mask()                       # (nlev, ncol)
    has_ocean = grid.kmax > 0                         # (ncol,)
    top_dzr = 1.0 / grid.cell_thickness[0]            # (ncol,)

    # ---- 1. surface fluxes ----
    sflux = bgc_surface_fluxes(
        state.bgc.tracers, forcing,
        state.bgc.surface_ph, state.bgc.surface_ph_alt, params.bgc)
    dflux = dms_surface_fluxes(
        state.dms[0, 0], forcing.sst, forcing.sss, forcing.ice_fraction,
        forcing.wind_speed_squared_10m, forcing.surface_pressure,
        params.dms)

    # ---- 2. interior tendencies ----
    bgc_out = bgc_source_sink(
        state.bgc.tracers, grid, forcing,
        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d, params.bgc,
        compute_diags=compute_diags, carbonate_impl=carbonate_impl,
        env=env, health=health)
    dms_tend, dms_diags = dms_source_sink(
        dms_tracer_block(state), grid.cell_thickness, active,
        forcing.sst, forcing.shortwave_surface, params.dms)
    mac_tend, mac_diags = macros_source_sink(
        macros_tracer_block(state), active, params.macros)

    # ---- 3. deposit surface fluxes into the top active cell ----
    surf_src = jnp.where(has_ocean, top_dzr, 0.0)     # (ncol,) 1/cm
    bgc_t = bgc_out.tendencies.at[0].add(surf_src[None, :]
                                         * sflux.net_flux)
    dms_t = dms_tend[:, (DT.DMS, DT.DMSP)]
    dms_t = dms_t.at[0, 0].add(surf_src * dflux.dms_flux)
    dms_t = dms_t.at[0, 1].add(surf_src * dflux.dmsp_flux)
    mac_t = mac_tend[:, (MT.PROT, MT.POLY, MT.LIP)]

    tend = CoupledTendencies(
        bgc=bgc_t, dms=dms_t, macros=mac_t,
        ph_prev_3d=bgc_out.ph_prev_3d,
        ph_prev_alt_3d=bgc_out.ph_prev_alt_3d,
        surface_ph=jnp.where(has_ocean, sflux.surface_ph,
                             state.bgc.surface_ph),
        surface_ph_alt=jnp.where(has_ocean, sflux.surface_ph_alt,
                                 state.bgc.surface_ph_alt),
    )

    diags: Dict[str, jax.Array] = {}
    if compute_diags:
        diags.update(bgc_out.diags)
        diags.update({f"DMS_{k}" if not k.startswith("DMS") else k: v
                      for k, v in dms_diags.items()})
        diags.update({f"MACROS_{k}": v for k, v in mac_diags.items()})
        diags.update(sflux.diags)
        diags.update(dflux.diags)
        diags["netFlux"] = sflux.net_flux
        if diag_dtype is not None:
            diags = {k: v.astype(diag_dtype) for k, v in diags.items()}
    if health and bgc_out.health is not None:
        diags["health_solver_nonconverged_cells"] = (
            bgc_out.health.solver_nonconverged_cells)
        diags["health_poc_error_cells"] = bgc_out.health.poc_error_cells
    if diag_filter is not None:
        # a filter with nothing to filter is a caller bug, not a no-op —
        # silently measuring/writing the diags-off configuration under a
        # selective-diagnostics label is exactly the mislabeled-artifact
        # failure mode this feature must not reintroduce
        if not compute_diags:
            raise ValueError(
                "diag_filter requires compute_diags=True (with "
                "compute_diags=False there are no diagnostics to "
                "select; health counters are emitted regardless)")
        unknown = set(diag_filter) - set(diags)
        if unknown:
            raise KeyError(
                f"unknown diagnostics {sorted(unknown)}; valid "
                f"names: {sorted(diags)}")
        keep = set(diag_filter)
        if health:
            # the health counters are monitoring, not history: they are
            # two scalars, promised even in diags-off runs, and callers
            # (run_model --health) read them every step — they always
            # survive the filter (listing them explicitly is a no-op)
            keep |= {"health_solver_nonconverged_cells",
                     "health_poc_error_cells"}
        diags = {k: v for k, v in diags.items() if k in keep}
    return tend, diags


def apply_update(state: CoupledState, tend: CoupledTendencies, dt,
                 *, bgc_incr=None, dms_incr=None,
                 macros_incr=None) -> CoupledState:
    """state + dt * increment, carrying the pH warm-start fields from the
    given tendency evaluation.  The increments default to the tendency
    fields (forward Euler); integrators pass combined stage sums."""
    return CoupledState(
        bgc=BGCState(
            tracers=state.bgc.tracers
            + dt * (tend.bgc if bgc_incr is None else bgc_incr),
            ph_prev_3d=tend.ph_prev_3d,
            ph_prev_alt_3d=tend.ph_prev_alt_3d,
            surface_ph=tend.surface_ph,
            surface_ph_alt=tend.surface_ph_alt,
        ),
        dms=state.dms + dt * (tend.dms if dms_incr is None else dms_incr),
        macros=state.macros
        + dt * (tend.macros if macros_incr is None else macros_incr),
    )


def step(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    *,
    compute_diags: bool = True,
    carbonate_impl: str = "auto",
    diag_dtype=None,
    env: EnvCache = None,
    health: bool = False,
    diag_filter=None,
) -> Tuple[CoupledState, Dict[str, jax.Array]]:
    """One coupled forward-Euler timestep (the host models' standard
    coupling scheme). Returns (state', diagnostics).

    ``env``: precomputed forcing-invariant coefficient tables
    (ops/bgc.py::precompute_env) — equal to refusion ulps, skips ~2/3
    of the step's transcendentals while the forcing snapshot is
    held.

    ``health``: emit the two production health counters into the
    returned diagnostics even when ``compute_diags=False`` (see
    :func:`evaluate_tendencies`).

    ``diag_filter``: emit exactly these diagnostic names (see
    :func:`evaluate_tendencies` — unconsumed diagnostics are
    dead-code-eliminated, recovering most of the diags-off
    throughput)."""
    tend, diags = evaluate_tendencies(state, grid, forcing, params,
                                      compute_diags=compute_diags,
                                      carbonate_impl=carbonate_impl,
                                      diag_dtype=diag_dtype, env=env,
                                      health=health,
                                      diag_filter=diag_filter)
    return apply_update(state, tend, dt), diags


def _tavg_sums0(track, state, step_fn):
    """Zero accumulators shaped like the tracked diagnostics
    (``jax.eval_shape``: no computation, just shapes)."""
    shapes = jax.eval_shape(lambda s: step_fn(s)[1], state)
    missing = set(track) - set(shapes)
    if missing:
        raise KeyError(f"unknown diagnostics: {sorted(missing)}")
    return {n: jnp.zeros(shapes[n].shape, shapes[n].dtype) for n in track}


def run(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    *,
    compute_diags: bool = False,
    tavg_fields=None,
    carbonate_impl: str = "auto",
    env_cache: bool = True,
):
    """Integrate ``nsteps`` with constant forcing as one compiled scan.

    Returns ``(final state, diags)`` — ``diags`` are the diagnostics of
    the FINAL step taken (its state update is used; no extra evaluation
    is paid, unlike the round-1 design which re-ran a full step just to
    read diagnostics).

    ``tavg_fields``: optional sequence of diagnostic names to
    time-average *inside* the compiled scan (the host model's "tavg"
    history layer, BGC_mod.F90:1794 comment).  When given, returns
    ``(final state, diags, TavgState)`` — the running sums live in the
    scan carry, and XLA dead-code-eliminates every diagnostic that is
    not tracked, so a 3-field history costs 3 fields, not ~155.

    ``env_cache``: hoist the forcing-invariant coefficient tables out
    of the scan.  **Default True since round 2** — a behavior change
    for pre-existing callers: results shift from the recompute-
    everything step by XLA-refusion ulps (~1e-14 relative at f64,
    amplified along chaotic trajectories), qualified by
    tests/test_env_cache.py and inside every correctness gate.  Pass
    ``env_cache=False`` to reproduce per-step recomputation (the
    reference's semantics, co2calc.F90:285-320) bit-for-bit.
    """
    from ocean_bgc.utils.history import TavgState

    track = tuple(tavg_fields) if tavg_fields is not None else ()

    # run() holds the forcing constant, so the forcing-invariant
    # coefficient tables are loop-invariant: evaluate them ONCE outside
    # the scan (refusion-ulp equal; ~2/3 of the per-step
    # transcendentals)
    env = precompute_env(grid, forcing, params.bgc) if env_cache else None

    def one_step(s, want_diags):
        return step(s, grid, forcing, params, dt,
                    compute_diags=want_diags,
                    carbonate_impl=carbonate_impl, env=env)

    sums0 = (_tavg_sums0(track, state, lambda s: one_step(s, True))
             if track else {})

    # the final step runs outside the scan iff its diagnostics are kept
    emit_final = compute_diags and nsteps >= 1
    nscan = nsteps - 1 if emit_final else nsteps

    def body(carry, _):
        s, sums = carry
        s2, d = one_step(s, bool(track))
        return (s2, {n: sums[n] + d[n] for n in track}), None

    (final, sums), _ = jax.lax.scan(body, (state, sums0), None,
                                    length=nscan)
    diags: Dict[str, jax.Array] = {}
    if emit_final:
        final, diags = one_step(final, True)
        sums = {n: sums[n] + diags[n] for n in track}

    if track:
        tavg = TavgState(sums=sums,
                         count=jnp.asarray(nsteps, jnp.int32))
        return final, diags, tavg
    return final, diags
