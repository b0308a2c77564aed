"""Transform composition: vmap ensembles over forcing perturbations.

An ensemble forecast (N perturbed forcings advancing in one fused program)
is a one-liner here — a capability with no analogue in the serial
reference.  Verifies vmap(step) against the per-member loop.
"""

import dataclasses

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def test_vmap_ensemble_matches_loop():
    state, grid, forcing, = synthetic_world(nlev=5, ncol=8, seed=91)
    params = ModelParams()
    n_ens = 4
    # perturb shortwave forcing per member
    factors = jnp.asarray([0.8, 0.9, 1.0, 1.1])

    def one_member(factor):
        f = dataclasses.replace(
            forcing, shortwave_surface=forcing.shortwave_surface * factor)
        new, _ = step(state, grid, f, params, 3600.0, compute_diags=False)
        return new.bgc.tracers

    ensemble = jax.jit(jax.vmap(one_member))(factors)
    assert ensemble.shape == (n_ens,) + state.bgc.tracers.shape

    for i, f in enumerate(np.asarray(factors)):
        want = one_member(jnp.asarray(f))
        np.testing.assert_allclose(np.asarray(ensemble[i]),
                                   np.asarray(want), rtol=1e-12, atol=0)

    # more light -> more surface carbon fixation -> lower surface DIC
    from ocean_bgc.state import BGCTracers as T
    dic_surf = np.asarray(ensemble)[:, 0, T.DIC, :].mean(axis=1)
    assert dic_surf[0] > dic_surf[-1]
