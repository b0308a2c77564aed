"""Opt-in single-precision fast path: finite, close to f64, and stable."""

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import run, step
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def test_fp32_step_close_to_fp64():
    params = ModelParams()
    s64, grid64, f64 = synthetic_world(nlev=8, ncol=16, seed=71,
                                       ragged=False)
    s32, grid32, f32 = synthetic_world(nlev=8, ncol=16, seed=71,
                                       ragged=False, dtype=jnp.float32)
    assert s32.bgc.tracers.dtype == jnp.float32

    out64, _ = step(s64, grid64, f64, params, 3600.0, compute_diags=False)
    out32, _ = step(s32, grid32, f32, params, 3600.0, compute_diags=False)
    assert out32.bgc.tracers.dtype == jnp.float32

    a = np.asarray(out64.bgc.tracers)
    b = np.asarray(out32.bgc.tracers, dtype=np.float64)
    # single-step agreement at single-precision level, scaled per tracer
    for i in range(a.shape[1]):
        scale = np.abs(a[:, i]).max() + 1e-30
        np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale,
                                   atol=2e-4, err_msg=f"tracer {i}")


def test_fp32_multi_step_stable():
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=8, ncol=16, seed=72,
                                           ragged=False, dtype=jnp.float32)
    final, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, 3600.0, 24))(state)
    trc = np.asarray(final.bgc.tracers)
    assert trc.dtype == np.float32
    assert np.isfinite(trc).all()


@pytest.mark.parametrize("backend, want_f32", [
    ("gpu", "pallas"), ("cpu", "xla")])
def test_carbonate_impl_auto_resolution(monkeypatch, backend, want_f32):
    """'auto' = the Pallas kernel only for f32 on a GPU; f64 everywhere
    and f32 off the GPU stay on the exact-contract XLA path; explicit
    names pass through; unknown names are rejected."""
    from ocean_bgc.ops.bgc import resolve_carbonate_impl as r

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert r("auto", jnp.float32) == want_f32
    assert r("auto", jnp.float64) == "xla"
    assert r("xla", jnp.float32) == "xla"
    assert r("pallas", jnp.float32) == "pallas"
    with pytest.raises(ValueError):
        r("cuda", jnp.float32)
