"""Time-varying forcing: climatology interpolation inside the compiled run.

The reference library receives a fresh ``BGC_forcing_type`` every call —
the host model (MPAS-Ocean/POP) owns the time axis and interpolates its
monthly/daily forcing climatologies onto each coupling step
(SURVEY.md §0: "the host owns ... time stepping").  A standalone
framework needs that host capability: this module integrates the coupled
model under a *forcing series* — a :class:`~ocean_bgc.state.BGCForcing`
pytree whose leaves carry a leading time-record axis — with per-step
linear interpolation (or nearest-record hold) done *inside* the
``lax.scan``, so the whole forced integration is still one XLA program
with zero host round-trips.

Series files: :func:`ocean_bgc.io.model_io.save_world` stores a single
snapshot; a series is just the same variables with a leading ``time``
record dimension (netcdf3 supports the UNLIMITED dim natively).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import CoupledState, step
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCForcing, ColumnGrid


def forcing_at(series: BGCForcing, t_frac) -> BGCForcing:
    """Linearly interpolate a forcing series at fractional record index
    ``t_frac`` (clamped to [0, T-1]).  Every leaf of ``series`` must have
    the time-record axis leading."""
    leaves = jax.tree.leaves(series)
    nrec = leaves[0].shape[0]
    t = jnp.clip(t_frac, 0.0, nrec - 1.0)
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, nrec - 1)
    i1 = jnp.clip(i0 + 1, 0, nrec - 1)
    w = t - i0

    def blend(leaf):
        a = jax.lax.dynamic_index_in_dim(leaf, i0, 0, keepdims=False)
        b = jax.lax.dynamic_index_in_dim(leaf, i1, 0, keepdims=False)
        return a + (b - a) * w.astype(a.dtype)

    return jax.tree.map(blend, series)


def forcing_record(series: BGCForcing, index) -> BGCForcing:
    """Select record ``index`` (no interpolation — 'hold' mode)."""
    return jax.tree.map(
        lambda leaf: jax.lax.dynamic_index_in_dim(
            leaf, jnp.asarray(index, jnp.int32), 0, keepdims=False),
        series)


def stack_forcings(records) -> BGCForcing:
    """Build a series from a sequence of per-record BGCForcing pytrees."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *records)


def run_forced(
    state: CoupledState,
    grid: ColumnGrid,
    series: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    record_dt: float,
    *,
    interp: str = "linear",
    t0: float = 0.0,
    compute_diags: bool = False,
    tavg_fields=None,
    carbonate_impl: str = "auto",
    env_mode: str = "auto",
):
    """Integrate ``nsteps`` under a time-varying forcing series.

    ``record_dt`` is the spacing (s) between consecutive forcing records;
    step ``i`` uses the forcing at model time ``t0 + (i + 1/2) * dt``
    (midpoint sampling, the standard host-coupling convention).
    ``interp``: "linear" blends the bracketing records, "hold" uses the
    nearest earlier record.

    ``env_mode`` — the forcing-invariant coefficient tables
    (:class:`ocean_bgc.ops.bgc.EnvCache`: the 11 equilibrium
    constants, solubilities, Q10 responses, dissolution decays —
    co2calc.F90:320-777 are pure (T, S, depth) functions) under a
    time-VARYING forcing:

    * ``"hold"`` — recompute the cache only when the scan crosses a
      record boundary (a ``lax.cond`` inside the scan), so each
      record's coefficient transcendentals are paid once instead of
      every step.  Requires ``interp="hold"``; per-step inputs are
      then *identical* to the uncached run's, and results agree to the
      same refusion-ulp class as :func:`ocean_bgc.models.coupled
      .run`'s env cache (tests/test_forcing_series.py pins it).
    * ``"interp"`` — carry the two bracketing records' caches and
      linearly blend the TABLES each step.  Requires
      ``interp="linear"``.  **A qualified approximation**: blending
      K(T0,S0) and K(T1,S1) is not K(T_blend, S_blend); the error is
      the chord-vs-curve gap of each coefficient over one record gap
      (second order in the record-to-record T/S change).  Qualified
      against the exact run in tests/test_forcing_series.py; not for
      the float64 reference-accuracy contract path.
    * ``"off"`` — recompute everything per step (the reference's
      semantics).
    * ``"auto"`` (default) — ``"hold"`` when ``interp="hold"`` (exact
      amortization), ``"off"`` when ``interp="linear"`` (the exact
      path; opt into ``"interp"`` explicitly).

    Returns ``(final state, diags)`` where ``diags`` belong to the final
    step taken (its update is used — no extra evaluation).  With
    ``tavg_fields`` (see :func:`ocean_bgc.models.coupled.run`)
    returns ``(final state, diags, TavgState)`` with the selected
    diagnostics time-averaged inside the compiled scan.
    """
    from ocean_bgc.models.coupled import _tavg_sums0
    from ocean_bgc.ops.bgc import precompute_env
    from ocean_bgc.utils.history import TavgState

    if interp not in ("linear", "hold"):
        raise ValueError(f"unknown interp mode {interp!r}")
    if env_mode == "auto":
        env_mode = "hold" if interp == "hold" else "off"
    if env_mode not in ("off", "hold", "interp"):
        raise ValueError(f"unknown env_mode {env_mode!r}")
    if env_mode == "hold" and interp != "hold":
        raise ValueError("env_mode='hold' is exact only under "
                         "interp='hold'; use env_mode='interp' (a "
                         "qualified approximation) with linear "
                         "interpolation")
    if env_mode == "interp" and interp != "linear":
        raise ValueError("env_mode='interp' blends bracketing records; "
                         "it requires interp='linear'")

    track = tuple(tavg_fields) if tavg_fields is not None else ()
    nrec = jax.tree.leaves(series)[0].shape[0]

    def t_frac(i):
        return (t0 + (i + 0.5) * dt) / record_dt

    def rec_of(i):
        return jnp.floor(jnp.clip(t_frac(i), 0, nrec - 1)
                         ).astype(jnp.int32)

    def forcing_for(i):
        if interp == "linear":
            return forcing_at(series, t_frac(i))
        return forcing_record(series, rec_of(i))

    def env_of(rec):
        return precompute_env(grid, forcing_record(series, rec),
                              params.bgc)

    def env_pair_of(rec):
        return env_of(rec), env_of(jnp.minimum(rec + 1, nrec - 1))

    def refresh(prev_rec, env_c, i):
        """Roll the cached tables forward iff step ``i`` crossed into a
        new forcing record; returns (rec, refreshed cache carry)."""
        rec = rec_of(i)
        if env_mode == "hold":
            env_c = jax.lax.cond(rec != prev_rec, env_of,
                                 lambda r: env_c, rec)
        else:   # interp
            env_c = jax.lax.cond(rec != prev_rec, env_pair_of,
                                 lambda r: env_c, rec)
        return rec, env_c

    def env_at(env_c, i):
        """The EnvCache the step at ``i`` should consume."""
        if env_mode == "hold":
            return env_c
        e0, e1 = env_c
        t = jnp.clip(t_frac(i), 0.0, nrec - 1.0)
        i0 = jnp.clip(jnp.floor(t), 0, nrec - 1)
        w = t - i0
        return jax.tree.map(
            lambda a, b: a + (b - a) * w.astype(a.dtype), e0, e1)

    def one_step(s, i, want_diags, env=None):
        return step(s, grid, forcing_for(i), params, dt,
                    compute_diags=want_diags,
                    carbonate_impl=carbonate_impl, env=env)

    sums0 = (_tavg_sums0(track, state, lambda s: one_step(s, 0, True))
             if track else {})

    emit_final = compute_diags and nsteps >= 1
    nscan = nsteps - 1 if emit_final else nsteps

    if env_mode == "off":
        def body(carry, i):
            s, sums = carry
            s2, d = one_step(s, i, bool(track))
            return (s2, {n: sums[n] + d[n] for n in track}), None

        (final, sums), _ = jax.lax.scan(body, (state, sums0),
                                        jnp.arange(nscan))
        diags: Dict[str, jax.Array] = {}
        if emit_final:
            final, diags = one_step(final, nsteps - 1, True)
            sums = {n: sums[n] + diags[n] for n in track}
    else:
        rec0 = rec_of(jnp.asarray(0))
        env_c0 = env_of(rec0) if env_mode == "hold" else env_pair_of(rec0)

        def body(carry, i):
            s, sums, prev_rec, env_c = carry
            rec, env_c = refresh(prev_rec, env_c, i)
            s2, d = one_step(s, i, bool(track), env=env_at(env_c, i))
            return (s2, {n: sums[n] + d[n] for n in track}, rec,
                    env_c), None

        (final, sums, last_rec, env_c), _ = jax.lax.scan(
            body, (state, sums0, rec0, env_c0), jnp.arange(nscan))
        diags = {}
        if emit_final:
            i_f = nsteps - 1
            _, env_c = refresh(last_rec, env_c, jnp.asarray(i_f))
            final, diags = one_step(final, i_f, True,
                                    env=env_at(env_c, i_f))
            sums = {n: sums[n] + diags[n] for n in track}

    if track:
        tavg = TavgState(sums=sums, count=jnp.asarray(nsteps, jnp.int32))
        return final, diags, tavg
    return final, diags


def save_forcing_series(path: str, series: BGCForcing, *,
                        record_dt: float) -> str:
    """Write a forcing series as NetCDF with ``time`` as the UNLIMITED
    record dimension (readable by any netCDF tool and by
    :func:`load_forcing_series`)."""
    import numpy as np

    from ocean_bgc.io import netcdf3 as nc

    leaves = {f.name: np.asarray(getattr(series, f.name))
              for f in dataclasses.fields(BGCForcing)}
    t, rest = next(iter(leaves.values())).shape[0], None
    sample = leaves["potential_temperature"]    # (T, nlev, ncol)
    nlev, ncol = sample.shape[1], sample.shape[2]
    ntrc = leaves["deposition_flux"].shape[1]

    ds = nc.Dataset()
    ds.dims = {"time": 0, "nlev": nlev, "ncol": ncol, "bgc_tracer": ntrc}
    ds.record_dim = "time"
    ds.attrs = {"title": "ocean_bgc forcing series",
                "record_dt_seconds": float(record_dt)}
    for name, a in leaves.items():
        if a.shape[1:] == (nlev, ncol):
            dims = ("time", "nlev", "ncol")
        elif a.shape[1:] == (ncol,):
            dims = ("time", "ncol")
        elif a.shape[1:] == (ntrc, ncol):
            dims = ("time", "bgc_tracer", "ncol")
        else:
            raise ValueError(f"{name}: unexpected shape {a.shape}")
        ds.variables[f"forcing_{name}"] = nc.Variable(dims, a)
    nc.write(path, ds)
    return path


def load_forcing_series(path: str, *, dtype=None):
    """Read a series written by :func:`save_forcing_series`.
    Returns (series, record_dt_seconds)."""
    from ocean_bgc.io import netcdf3 as nc

    ds = nc.read(path)
    kw = {}
    for f in dataclasses.fields(BGCForcing):
        v = ds.variables[f"forcing_{f.name}"].data
        if dtype is not None and v.dtype.kind == "f":
            v = v.astype(dtype)
        kw[f.name] = jnp.asarray(v)
    return BGCForcing(**kw), float(ds.attrs["record_dt_seconds"])
