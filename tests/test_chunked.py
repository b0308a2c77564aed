"""Column-chunked stepping == unchunked stepping, including ragged tails."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax

from ocean_bgc.models.chunked import host_world_like, step_chunked
from ocean_bgc.models.coupled import run
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def test_chunked_matches_unchunked():
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=5, ncol=37, seed=9)

    want, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, 3600.0, 3))(state)

    hs, hg, hf = host_world_like(state, grid, forcing)
    got = step_chunked(hs, hg, hf, params, 3600.0, chunk=16, nsteps=3)

    # chunk width 16 over 37 columns: two full chunks + a padded tail.
    # agreement is to compile-variant ulps (different batch shapes
    # compile different executables; see module docstring)
    for a, b in ((got.bgc.tracers, want.bgc.tracers),
                 (got.bgc.ph_prev_3d, want.bgc.ph_prev_3d),
                 (got.dms, want.dms), (got.macros, want.macros)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-18)


def test_chunked_single_chunk_covers_all():
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=4, ncol=9, seed=10)
    want, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, 3600.0, 1))(state)
    hs, hg, hf = host_world_like(state, grid, forcing)
    got = step_chunked(hs, hg, hf, params, 3600.0, chunk=1024)
    np.testing.assert_allclose(np.asarray(got.bgc.tracers),
                               np.asarray(want.bgc.tracers),
                               rtol=1e-12, atol=1e-18)
