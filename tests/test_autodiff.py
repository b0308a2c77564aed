"""Reverse-mode differentiability: implicit-diff pH solver + whole model.

The Fortran reference has no adjoint; here jax.grad flows through the
carbonate root-find (custom VJP via the implicit function theorem) and the
full coupled step — enabling parameter sensitivity and data assimilation.
"""

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.ops import carbonate as carb
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def test_ph_solver_gradient_matches_finite_difference():
    def ph_of_dic(dic):
        ph, *_ = carb.co3_terms(
            jnp.zeros(()), jnp.asarray(15.0), jnp.asarray(35.0),
            dic, jnp.asarray(2300.0), jnp.asarray(1.0), jnp.asarray(30.0),
            jnp.asarray(6.0), jnp.asarray(9.0), False)
        return ph

    dic0 = jnp.asarray(2100.0)
    g = jax.grad(ph_of_dic)(dic0)
    # the solver truncates at xacc, so finite differences carry ~1e-6 pH
    # noise; a 1 mmol/m^3 step keeps the FD signal well above it
    eps = 1.0
    fd = (float(ph_of_dic(dic0 + eps)) - float(ph_of_dic(dic0 - eps))) / (
        2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=5e-3)
    assert float(g) < 0.0   # more DIC -> more acidic


def test_gradient_wrt_alkalinity_and_temp():
    def pco2_of(alk, temp):
        _, _, _, pco2, _ = carb.co2calc_surface(
            jnp.zeros(()), temp, jnp.asarray(35.0), jnp.asarray(2050.0),
            alk, jnp.asarray(0.5), jnp.asarray(5.0),
            jnp.asarray(7.0), jnp.asarray(9.0),
            jnp.asarray(415.0), jnp.asarray(1.0))
        return pco2

    g_alk, g_t = jax.grad(pco2_of, argnums=(0, 1))(
        jnp.asarray(2300.0), jnp.asarray(18.0))
    # more alkalinity -> lower pCO2; warmer -> higher pCO2
    assert float(g_alk) < 0.0
    assert float(g_t) > 0.0
    # finite-difference check on alkalinity
    eps = 1e-2
    fd = (float(pco2_of(jnp.asarray(2300.0 + eps), jnp.asarray(18.0)))
          - float(pco2_of(jnp.asarray(2300.0 - eps),
                          jnp.asarray(18.0)))) / (2 * eps)
    np.testing.assert_allclose(float(g_alk), fd, rtol=1e-3)


def test_grad_through_full_coupled_step():
    state, grid, forcing, = synthetic_world(nlev=5, ncol=8, seed=41)
    params = ModelParams()

    def loss(tracers):
        import dataclasses
        s = dataclasses.replace(
            state, bgc=dataclasses.replace(state.bgc, tracers=tracers))
        new, _ = step(s, grid, forcing, params, 3600.0,
                      compute_diags=False)
        return jnp.sum(new.bgc.tracers[0, 6] ** 2)   # surface DIC

    g = jax.grad(loss)(state.bgc.tracers)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
