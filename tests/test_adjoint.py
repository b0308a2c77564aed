"""Trajectory adjoints + variational calibration (models/adjoint.py).

The reference has no adjoint (BGC parameters are hand-set constants,
BGC_parms.F90:497-699); here reverse-mode AD through the full coupled
integration is exact, remat-able, shards like the forward model, and
drives parameter estimation from observed trajectories.
"""

import dataclasses

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.adjoint import (
    calibrate,
    get_param,
    override_params,
    parameter_sensitivities,
    run_diff,
)
from ocean_bgc.models.coupled import run
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as BT
from ocean_bgc.utils.synthetic import synthetic_world

DT = 3600.0


def world(**kw):
    kw.setdefault("nlev", 6)
    kw.setdefault("ncol", 8)
    kw.setdefault("seed", 73)
    kw.setdefault("ragged", False)
    return synthetic_world(**kw)


def test_override_params_paths():
    p = ModelParams()
    assert get_param(p, "bgc.parm_kappa_nitrif") == p.bgc.parm_kappa_nitrif
    assert get_param(p, "bgc.autotrophs[1].kSiO3") == 0.8

    p2 = override_params(p, {
        "bgc.parm_kappa_nitrif": 1.0e-6,
        "bgc.autotrophs[0].PCref": 2.0e-5,
        "dms.k_conv": 3.0e-6,
    })
    assert get_param(p2, "bgc.parm_kappa_nitrif") == 1.0e-6
    assert get_param(p2, "bgc.autotrophs[0].PCref") == 2.0e-5
    assert get_param(p2, "dms.k_conv") == 3.0e-6
    # untouched fields and sibling tuple entries are preserved
    assert p2.bgc.autotrophs[0].kFe == p.bgc.autotrophs[0].kFe
    assert p2.bgc.autotrophs[1] is p.bgc.autotrophs[1]
    assert p2.macros is p.macros

    with pytest.raises(TypeError):
        override_params(p, {"bgc.autotrophs[0].temp_function": 1})
    with pytest.raises(TypeError):
        override_params(p, {"bgc.lrest_no3": 1.0})
    with pytest.raises(AttributeError):
        get_param(p, "bgc.not_a_field")


def test_run_diff_forward_matches_run():
    state, grid, forcing = world()
    params = ModelParams()
    want, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, 4))(state)
    got = jax.jit(
        lambda s: run_diff(s, grid, forcing, params, DT, 4))(state)
    np.testing.assert_allclose(np.asarray(got.bgc.tracers),
                               np.asarray(want.bgc.tracers),
                               rtol=1e-14, atol=0.0)


def test_trajectory_param_grad_matches_finite_difference():
    state, grid, forcing = world()
    template = ModelParams()
    path = "bgc.parm_kappa_nitrif"
    p0 = get_param(template, path)

    def loss_of(value):
        params = override_params(template, {path: value})
        final = run_diff(state, grid, forcing, params, DT, 5)
        return jnp.mean(final.bgc.tracers[:, BT.NO3] ** 2)

    g = jax.jit(jax.grad(loss_of))(jnp.asarray(p0))
    lf = jax.jit(loss_of)
    eps = 1e-2 * p0
    fd = (float(lf(p0 + eps)) - float(lf(p0 - eps))) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=2e-3)
    assert float(g) > 0.0   # more nitrification -> more NO3


def test_remat_gradient_matches_no_remat():
    state, grid, forcing = world(nlev=5, ncol=4)
    params = ModelParams()

    def loss(tracers, remat):
        s = dataclasses.replace(
            state, bgc=dataclasses.replace(state.bgc, tracers=tracers))
        final = run_diff(s, grid, forcing, params, DT, 4, remat=remat)
        return jnp.sum(final.bgc.tracers[0, BT.DIC] ** 2)

    g_remat = jax.jit(jax.grad(lambda t: loss(t, True)))(state.bgc.tracers)
    g_plain = jax.jit(jax.grad(lambda t: loss(t, False)))(state.bgc.tracers)
    np.testing.assert_allclose(np.asarray(g_remat), np.asarray(g_plain),
                               rtol=1e-12, atol=0.0)
    assert float(jnp.max(jnp.abs(g_remat))) > 0.0


def test_adjoint_shards_like_the_forward_model():
    """The parameter gradient computed on the 8-device columns mesh equals
    the single-device gradient — the psum over shards is inserted by XLA,
    exactly as the forward model's sharding story promises."""
    from ocean_bgc.parallel import make_mesh, shard_world

    state, grid, forcing = world(ncol=16)
    template = ModelParams()
    path = "bgc.autotrophs[0].PCref"
    p0 = get_param(template, path)

    def loss_of(value, st, gr, fo):
        params = override_params(template, {path: value})
        final = run_diff(st, gr, fo, params, DT, 3)
        return jnp.mean(final.bgc.tracers[0, BT.DIC] ** 2)

    g1 = jax.jit(jax.grad(loss_of))(jnp.asarray(p0), state, grid, forcing)

    mesh = make_mesh()
    s_state, s_grid, s_forcing = shard_world(state, grid, forcing, mesh)
    g8 = jax.jit(jax.grad(loss_of))(jnp.asarray(p0), s_state, s_grid,
                                    s_forcing)
    np.testing.assert_allclose(float(g8), float(g1), rtol=1e-12)


def test_grad_through_forced_run():
    """The time-varying-forcing production path (run_forced, per-record
    env cache inside the scan) is reverse-differentiable too — here a
    gradient with respect to a forcing-series amplitude (a
    climate-sensitivity-style question the reference cannot ask)."""
    import dataclasses

    from ocean_bgc.models.forcing_series import (
        run_forced, stack_forcings)

    nlev, ncol, nrec = 5, 6, 3
    worlds = [synthetic_world(nlev=nlev, ncol=ncol, seed=200 + r,
                              ragged=False) for r in range(nrec)]
    state, grid, _ = worlds[0]
    series = stack_forcings([w[2] for w in worlds])
    params = ModelParams()

    def loss_of(scale):
        s2 = dataclasses.replace(
            series, shortwave_surface=series.shortwave_surface * scale)
        final, _ = run_forced(state, grid, s2, params, DT, 6, 2 * DT)
        return jnp.mean(final.bgc.tracers[0, BT.DIC])

    g = jax.jit(jax.grad(loss_of))(jnp.asarray(1.0))
    assert np.isfinite(float(g))
    # more light -> more surface carbon fixation -> lower surface DIC
    assert float(g) < 0.0


def test_sensitivities_one_sweep_matches_single_param_grad():
    """One reverse sweep over 3 parameters agrees with the dedicated
    single-parameter gradient (and FD, transitively, via the test above)."""
    state, grid, forcing = world(nlev=5, ncol=4)
    template = ModelParams()
    paths = ("bgc.parm_kappa_nitrif", "bgc.autotrophs[0].PCref",
             "bgc.parm_POC_diss")

    def functional(final):
        return jnp.mean(final.bgc.tracers[:, BT.NO3] ** 2)

    sens = parameter_sensitivities(
        template, paths, state, grid, forcing, DT, 3, functional)
    assert set(sens) == set(paths)
    assert all(np.isfinite(v) for v in sens.values())
    assert sens["bgc.parm_kappa_nitrif"] > 0.0

    # cross-check one entry against a direct single-parameter gradient
    path = "bgc.parm_kappa_nitrif"
    p0 = get_param(template, path)

    def loss_of(value):
        params = override_params(template, {path: value})
        final = run_diff(state, grid, forcing, params, DT, 3)
        return functional(final)

    g = jax.jit(jax.grad(loss_of))(jnp.asarray(p0))
    np.testing.assert_allclose(sens[path], float(g) * p0, rtol=1e-10)


def test_calibration_recovers_perturbed_growth_rate():
    """Twin experiment: generate observations with the true params, start
    the optimizer from a 1.4x-perturbed small-phyto PCref, and recover the
    truth from surface-tracer trajectories."""
    state, grid, forcing = world()
    truth = ModelParams()
    path = "bgc.autotrophs[0].PCref"
    true_val = get_param(truth, path)

    def obs_fn(s):
        return s.bgc.tracers[0][(BT.SPC, BT.SPCHL, BT.DIC), :]

    _, observations = jax.jit(
        lambda s: run_diff(s, grid, forcing, truth, DT, 6,
                           obs_fn=obs_fn))(state)

    first_guess = override_params(truth, {path: 1.4 * true_val})
    result = calibrate(
        first_guess, [path], state, grid, forcing, DT, 6,
        observations, obs_fn, iters=60, learning_rate=0.1)

    assert result.losses[-1] < 1e-2 * result.losses[0], result.losses
    fitted = result.values[path]
    np.testing.assert_allclose(fitted, true_val, rtol=0.03)
    # the returned params carry the fit
    assert get_param(result.params, path) == fitted
