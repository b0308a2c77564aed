"""MACROS kernel vs the scalar oracle, including ragged-depth masking."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.macros import macros_source_sink
from ocean_bgc.params import MACROSParams
from ocean_bgc.state import MACROSTracers as MT
from tests.oracle import trace_gas_ref as ref


def _setup(rng, nlev=12, ncol=17):
    tracers = rng.uniform(0.0, 3.0, (nlev, MT.CNT, ncol))
    tracers[0, :, 0] = -0.5         # negative clip path
    kmax = rng.integers(0, nlev + 1, ncol)  # includes land columns (kmax=0)
    kmax[3] = 0
    kmax[5] = nlev
    return tracers, kmax


def test_macros_matches_oracle(rng):
    tracers, kmax = _setup(rng)
    params = MACROSParams()
    nlev, ncol = tracers.shape[0], tracers.shape[2]
    k = np.arange(nlev)[:, None]
    active = k < kmax[None, :]
    tend, diags = macros_source_sink(jnp.asarray(tracers),
                                     jnp.asarray(active), params)
    want_tend, want_diags = ref.macros_source_sink(tracers, kmax, params)
    np.testing.assert_allclose(np.asarray(tend), want_tend, rtol=1e-13,
                               atol=1e-20)
    for name in want_diags:
        np.testing.assert_allclose(np.asarray(diags[name]),
                                   want_diags[name], rtol=1e-13, atol=1e-20)


def test_macros_inactive_levels_zero(rng):
    tracers, kmax = _setup(rng)
    params = MACROSParams()
    nlev, ncol = tracers.shape[0], tracers.shape[2]
    active = np.arange(nlev)[:, None] < kmax[None, :]
    tend, diags = macros_source_sink(jnp.asarray(tracers),
                                     jnp.asarray(active), params)
    tend = np.asarray(tend)
    assert (tend[:, :, 3] == 0.0).all()          # land column
    for col in range(ncol):
        assert (tend[kmax[col]:, :, col] == 0.0).all()
