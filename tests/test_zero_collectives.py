"""Mechanical proof of the scaling story: the compiled sharded step
contains ZERO collective ops.

The >90% weak-scaling gate (BASELINE.md) cannot be *measured* on the
virtual CPU mesh, which under-reads because all 8 "devices" share one
socket.  But the argument behind the gate — columns never communicate,
so the step program has no cross-device traffic at all, and the only
collective anywhere is the opt-in global-diagnostics psum (SURVEY.md par.2 "Global reductions:
none in-library") — is a property of the compiled program, not of
hardware.  These tests pin it at the IR level: grep the StableHLO and
the compiled HLO of the production sharded step for every collective op
XLA can emit.

With global diags + health counters on, the program must contain
EXACTLY the expected all_reduces (6 GLOBAL_SUM_DIAGS + 2 HEALTH_DIAGS)
and still no other collective kind — the per-step cross-ICI traffic is
8 scalars, period.
"""

import re

import ocean_bgc  # noqa: F401
from ocean_bgc.parallel import make_mesh, make_sharded_step, shard_world
from ocean_bgc.parallel.sharding import GLOBAL_SUM_DIAGS, HEALTH_DIAGS
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world

_STABLEHLO_COLLECTIVES = (
    "stablehlo.all_reduce", "stablehlo.all_gather", "stablehlo.all_to_all",
    "stablehlo.collective_permute", "stablehlo.reduce_scatter",
    "stablehlo.collective_broadcast",
)
_HLO_COLLECTIVES = (
    "all-reduce", "all-gather", "all-to-all", "collective-permute",
    "reduce-scatter", "collective-broadcast", "ragged-all-to-all",
)


def _lower(compute_diags, health):
    mesh = make_mesh()
    state, grid, forcing = synthetic_world(nlev=6, ncol=64, seed=5,
                                           ragged=False)
    state, grid, forcing = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, ModelParams(), 3600.0,
                           compute_diags=compute_diags, health=health)
    return fn.lower(state, grid, forcing)


def _count(text, needles):
    # word-boundary match so "all-reduce-start"/"all-reduce-done" (async
    # pairs) still register as collective traffic
    return {n: len(re.findall(re.escape(n), text)) for n in needles}


def test_production_step_has_zero_collectives():
    lowered = _lower(compute_diags=False, health=False)
    stable = _count(lowered.as_text(), _STABLEHLO_COLLECTIVES)
    assert not any(stable.values()), stable
    hlo = _count(lowered.compile().as_text(), _HLO_COLLECTIVES)
    assert not any(hlo.values()), hlo


def test_diags_step_has_exactly_the_psums():
    lowered = _lower(compute_diags=True, health=True)
    stable = _count(lowered.as_text(), _STABLEHLO_COLLECTIVES)
    expected = len(GLOBAL_SUM_DIAGS) + len(HEALTH_DIAGS)
    assert stable["stablehlo.all_reduce"] == expected, stable
    others = {k: v for k, v in stable.items()
              if k != "stablehlo.all_reduce"}
    assert not any(others.values()), others
    # after XLA optimization: all-reduce may split into start/done pairs
    # or fuse, but no OTHER collective kind may appear
    hlo = _count(lowered.compile().as_text(), _HLO_COLLECTIVES)
    others = {k: v for k, v in hlo.items() if k != "all-reduce"}
    assert not any(others.values()), others
    assert hlo["all-reduce"] >= 1


def test_sharded_forced_run_has_zero_collectives():
    """The time-varying-forcing production path (make_sharded_forced_run:
    in-scan climatology interpolation + per-record env cache) must also
    compile to zero collectives — the forcing series shards like a
    snapshot and every record-boundary refresh happens on-chip."""
    from ocean_bgc.models.forcing_series import stack_forcings
    from ocean_bgc.parallel.sharding import (make_sharded_forced_run,
                                             col_sharding_tree)
    import jax

    mesh = make_mesh()
    worlds = [synthetic_world(nlev=6, ncol=64, seed=50 + r,
                              ragged=False) for r in range(3)]
    state, grid, _ = worlds[0]
    series = stack_forcings([w[2] for w in worlds])
    put = lambda t: jax.device_put(t, col_sharding_tree(t, mesh))  # noqa: E731
    state, grid, series = put(state), put(grid), put(series)
    fn = make_sharded_forced_run(mesh, ModelParams(), 3600.0, nsteps=4,
                                 record_dt=7200.0, interp="hold",
                                 env_mode="hold")
    lowered = fn.lower(state, grid, series)
    stable = _count(lowered.as_text(), _STABLEHLO_COLLECTIVES)
    assert not any(stable.values()), stable
    hlo = _count(lowered.compile().as_text(), _HLO_COLLECTIVES)
    assert not any(hlo.values()), hlo
