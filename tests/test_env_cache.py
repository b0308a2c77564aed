"""Forcing-invariant coefficient tables (the env cache).

The cache evaluates exactly the expressions the in-step code would, on
the same inputs.  Removing the coefficient ops from the level-scan body
changes XLA's per-body refusion, so results shift by a few ulps (the
same class as the pinned unroll=4 refusion, measured ~1.6e-14 relative
at f64) — pinned tightly here so any REAL divergence (a cache/in-step
expression mismatch) fails loudly.
"""

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp
import pytest

from ocean_bgc.models.coupled import run, step
from ocean_bgc.ops.bgc import bgc_source_sink, precompute_env
from ocean_bgc.params import BGCParams, ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


@pytest.mark.parametrize("dtype", [None, jnp.float32])
@pytest.mark.parametrize("diags", [False, True])
def test_env_cache_ulp_equivalence(dtype, diags):
    state, grid, forcing = synthetic_world(nlev=12, ncol=32, seed=9,
                                           ragged=True, dtype=dtype)
    params = BGCParams()
    env = precompute_env(grid, forcing, params)

    a = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=diags,
                        carbonate_impl="xla")
    b = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=diags,
                        carbonate_impl="xla", env=env)

    # f32 refusion shifts reach ~1e-5 relative on near-cancellation
    # cells (abs ~5e-14); f64 stays at ~1e-14 relative
    rtol = 1e-12 if dtype is None else 5e-5
    atol = 1e-280 if dtype is None else 1e-12
    np.testing.assert_allclose(np.asarray(a.tendencies),
                               np.asarray(b.tendencies),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(a.ph_prev_3d),
                               np.asarray(b.ph_prev_3d),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(a.ph_prev_alt_3d),
                               np.asarray(b.ph_prev_alt_3d),
                               rtol=rtol, atol=atol)
    for k in a.diags:
        if k.startswith("Jint"):
            # conservation integrals are ~0 by construction: pure
            # cancellation of large terms, so only an absolute
            # comparison at the conservation noise floor is meaningful
            np.testing.assert_allclose(
                np.asarray(a.diags[k]), np.asarray(b.diags[k]),
                rtol=0.0, atol=1e-13 if dtype is None else 0.1,
                err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(a.diags[k]),
                                       np.asarray(b.diags[k]),
                                       rtol=rtol, atol=atol, err_msg=k)


def test_env_cache_pallas_carbonate(pallas_interpret):
    """The coefficient-fed Pallas carbonate kernel (interpret mode on
    CPU) agrees with the compute-in-kernel variant to f32 tolerance."""
    state, grid, forcing = synthetic_world(nlev=8, ncol=16, seed=13,
                                           ragged=True,
                                           dtype=jnp.float32)
    params = BGCParams()
    env = precompute_env(grid, forcing, params)

    a = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=True,
                        carbonate_impl="pallas")
    b = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=True,
                        carbonate_impl="pallas", env=env)
    np.testing.assert_allclose(np.asarray(a.ph_prev_3d),
                               np.asarray(b.ph_prev_3d),
                               rtol=0.0, atol=5e-5)
    for k in ("CO3", "co3_sat_calc", "co3_sat_arag", "pH_3D"):
        np.testing.assert_allclose(np.asarray(a.diags[k]),
                                   np.asarray(b.diags[k]),
                                   rtol=2e-4, atol=1e-8, err_msg=k)


def test_env_cache_ulp_equivalence_jitted_step():
    """Same property through the jitted coupled step (the bench path)."""
    state, grid, forcing = synthetic_world(nlev=10, ncol=16, seed=2,
                                           ragged=True)
    params = ModelParams()
    env = precompute_env(grid, forcing, params.bgc)

    s1, _ = jax.jit(lambda s: step(s, grid, forcing, params, 3600.0,
                                   compute_diags=False))(state)
    s2, _ = jax.jit(lambda s: step(s, grid, forcing, params, 3600.0,
                                   compute_diags=False, env=env))(state)
    np.testing.assert_allclose(np.asarray(s1.bgc.tracers),
                               np.asarray(s2.bgc.tracers),
                               rtol=1e-12, atol=1e-280)
    np.testing.assert_allclose(np.asarray(s1.bgc.ph_prev_3d),
                               np.asarray(s2.bgc.ph_prev_3d),
                               rtol=1e-12, atol=0.0)


def test_env_cache_staleness_guard(monkeypatch):
    """A cache built from one forcing snapshot and used after the host
    moved (T, S) is caught by the fingerprint check (OBGC_CHECK_ENV=1),
    eagerly and under jit; a fresh cache passes."""
    import dataclasses

    from ocean_bgc.ops.bgc import check_env_cache

    monkeypatch.setenv("OBGC_CHECK_ENV", "1")
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=4,
                                           ragged=True)
    params = BGCParams()
    env = precompute_env(grid, forcing, params)
    stale = dataclasses.replace(
        forcing,
        potential_temperature=forcing.potential_temperature + 0.5)

    # fresh cache passes the guard (and the guarded call still works)
    bgc_source_sink(state.bgc.tracers, grid, forcing,
                    state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                    params, compute_diags=False, env=env)

    # eager call with moved forcing raises
    with pytest.raises(ValueError, match="stale EnvCache"):
        bgc_source_sink(state.bgc.tracers, grid, stale,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=False, env=env)

    # direct host-facing check too
    with pytest.raises(ValueError, match="stale EnvCache"):
        check_env_cache(env, grid, stale)

    # traced call: the host callback surfaces the error on sync
    fn = jax.jit(lambda t: bgc_source_sink(
        t, grid, stale, state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
        params, compute_diags=False, env=env).ph_prev_3d)
    with pytest.raises(Exception, match="stale EnvCache"):
        jax.block_until_ready(fn(state.bgc.tracers))

    # guard off by default: the same stale call goes through silently
    monkeypatch.setenv("OBGC_CHECK_ENV", "0")
    bgc_source_sink(state.bgc.tracers, grid, stale,
                    state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                    params, compute_diags=False, env=env)


def test_run_env_cache_default():
    """run() hoists the cache outside its scan by default; the 5-step
    trajectory agrees with env_cache=False to amplified refusion ulps."""
    state, grid, forcing = synthetic_world(nlev=8, ncol=12, seed=6,
                                           ragged=True)
    params = ModelParams()
    a, _ = jax.jit(lambda s: run(s, grid, forcing, params, 3600.0, 5,
                                 env_cache=True))(state)
    b, _ = jax.jit(lambda s: run(s, grid, forcing, params, 3600.0, 5,
                                 env_cache=False))(state)
    np.testing.assert_allclose(np.asarray(a.bgc.tracers),
                               np.asarray(b.bgc.tracers),
                               rtol=1e-10, atol=1e-280)
    np.testing.assert_allclose(np.asarray(a.dms), np.asarray(b.dms),
                               rtol=1e-10, atol=1e-280)


def test_standin_seed_bitwise_invariant_and_faster():
    """Round-5 inactive-lane warm seeding (EnvCache.standin_ph):

    1. every public output — state AND all diagnostics — is BITWISE
       identical with and without the seed (the seeded brackets feed
       only the discarded inactive-lane results; per-lane freezing
       makes active lanes' iterate sequences independent of
       batchmates);
    2. the batched solver's max iteration count (= the while_loop trip
       count every step pays) drops to the warm-lane level (13 -> 3
       on the flagship world, scripts/ph_iter_stats.py).
    """
    from ocean_bgc import constants as c
    from ocean_bgc.ops.carbonate import (
        _to_mass_units, solve_htotal_stats, warm_brackets_h)
    from ocean_bgc.state import BGCTracers as T

    state, grid, forcing = synthetic_world(nlev=12, ncol=64, seed=3,
                                           ragged=True)
    params = ModelParams()
    env = precompute_env(grid, forcing, params.bgc)
    assert env.standin_ph is not None
    env_noseed = env._replace(standin_ph=None)

    s1, s2 = state, state
    for _ in range(3):
        s1, d1 = step(s1, grid, forcing, params, 3600.0, env=env)
        s2, d2 = step(s2, grid, forcing, params, 3600.0, env=env_noseed)
    for a, b in zip(jax.tree.leaves((s1, d1)), jax.tree.leaves((s2, d2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the warm-regime iteration distribution, as bgc_source_sink forms it
    active = grid.active_mask()
    assert not bool(np.asarray(active).all())      # world has inactive lanes
    trc = jnp.maximum(s1.bgc.tracers, 0.0)
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(
        jnp.where(active, trc[:, T.DIC], 2000.0),
        jnp.where(active, trc[:, T.ALK], 2300.0),
        trc[:, T.PO4], trc[:, T.SIO3])

    def max_iters(ph_seed):
        br = warm_brackets_h(ph_seed, c.PHLO_3D_INIT, c.PHHI_3D_INIT,
                             c.DEL_PH)
        _, iters, conv = solve_htotal_stats(env.coeffs, dic_m, ta_m,
                                            pt_m, sit_m, br[0], br[1])
        assert bool(np.asarray(conv).all())
        return int(np.asarray(iters).max())

    unseeded = max_iters(s1.bgc.ph_prev_3d)
    seeded = max_iters(jnp.where(active, s1.bgc.ph_prev_3d,
                                 env.standin_ph))
    assert unseeded >= 8, unseeded     # cold inactive lanes dominate
    assert seeded <= 4, seeded         # warm-lane level
