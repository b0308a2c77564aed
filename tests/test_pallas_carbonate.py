"""Pallas fp32 carbonate kernel (Triton route) vs the XLA fp32 path.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
the tests marked ``gpu`` run the compiled kernel and skip here
(``python chip_smoke.py`` makes the same checks on the card)."""

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.ops import pallas_carbonate
from ocean_bgc.ops.carbonate import (carbonate_coeffs, co3_sat_vals,
                                     co3_terms_dual)
from ocean_bgc.ops.pallas_carbonate import co3_terms_dual_sat_pallas


def _world(rng, n):
    f32 = jnp.float32
    return (jnp.asarray(rng.uniform(0, 5000, n), f32),      # depth
            jnp.asarray(rng.uniform(-1.8, 31, n), f32),     # temp
            jnp.asarray(rng.uniform(30, 40, n), f32),       # salt
            jnp.asarray(rng.uniform(1800, 2400, n), f32),   # dic
            jnp.asarray(rng.uniform(2000, 2500, n), f32),   # ta
            jnp.asarray(rng.uniform(0, 3.5, n), f32),       # pt
            jnp.asarray(rng.uniform(0, 150, n), f32))       # sit


def _check_close(refs, gots, shape):
    for ref, got in zip(refs, gots):
        assert got.dtype == jnp.float32
        assert got.shape == shape
        r = np.asarray(ref, np.float64)
        g = np.asarray(got, np.float64)
        scale = np.abs(r).max() + 1e-30
        np.testing.assert_allclose(g / scale, r / scale, atol=3e-4)


def test_pallas_matches_xla_f32(rng):
    n = 1500   # deliberately not a multiple of the block
    depth, temp, salt, dic, ta, pt, sit = _world(rng, n)
    lo = jnp.full(n, 6.0, jnp.float32)
    hi = jnp.full(n, 9.0, jnp.float32)
    press = depth > 10.0

    a, b = co3_terms_dual(depth, temp, salt, dic, ta, pt, sit,
                          lo, hi, lo + 0.1, hi - 0.1, press)
    sat = co3_sat_vals(depth, temp, salt, press)
    pa, pb, psat = co3_terms_dual_sat_pallas(
        depth, temp, salt, dic, ta, pt, sit,
        lo, hi, lo + 0.1, hi - 0.1, press, interpret=True)
    _check_close(a + b + sat, pa + pb + psat, (n,))


@pytest.mark.parametrize("n_blocks, extra", [(3, 0), (2, 37)])
def test_pallas_padding_and_cached_coeffs(rng, n_blocks, extra):
    """Cell counts on and off the block boundary, with the cached
    coefficients: padded lanes are cut off and never leak into the
    real cells."""
    n = n_blocks * pallas_carbonate._BLOCK + extra
    depth, temp, salt, dic, ta, pt, sit = _world(rng, n)
    lo = jnp.full(n, 6.0, jnp.float32)
    hi = jnp.full(n, 9.0, jnp.float32)
    press = depth > 10.0
    coeffs = carbonate_coeffs(depth, temp, salt, press)

    a, b = co3_terms_dual(depth, temp, salt, dic, ta, pt, sit,
                          lo, hi, lo + 0.1, hi - 0.1, press, coeffs=coeffs)
    pa, pb, psat = co3_terms_dual_sat_pallas(
        depth, temp, salt, dic, ta, pt, sit, lo, hi, lo + 0.1, hi - 0.1,
        press, coeffs=coeffs, with_sat=False, interpret=True)
    assert psat is None
    _check_close(a + b, pa + pb, (n,))


def test_pallas_2d_shape_and_warm_start(rng):
    nlev, ncol = 7, 23
    depth, temp, salt, dic, ta, pt, sit = _world(rng, nlev * ncol)
    shp = (nlev, ncol)
    args = [v.reshape(shp) for v in (depth, temp, salt, dic, ta, pt, sit)]
    ph_prev = jnp.full(shp, 8.0, jnp.float32)
    press = jnp.asarray(np.arange(nlev) > 0)[:, None] & jnp.ones(
        (1, ncol), bool)

    (ph_a, *_), _, _ = co3_terms_dual_sat_pallas(
        *args, ph_prev - 0.5, ph_prev + 0.5, ph_prev - 0.5, ph_prev + 0.5,
        press, interpret=True)
    assert ph_a.shape == shp
    # the warm bracket contains the solution for typical seawater
    assert np.isfinite(np.asarray(ph_a)).all()
    assert (np.asarray(ph_a) > 6.0).all() and (np.asarray(ph_a) < 9.5).all()


def test_pallas_refuses_cpu_without_interpret(rng):
    """No silent interpreter: without ``interpret=True`` the kernel only
    compiles for the GPU, and the CPU backend refuses it."""
    depth, temp, salt, dic, ta, pt, sit = _world(rng, 8)
    lo = jnp.full(8, 6.0, jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        co3_terms_dual_sat_pallas(depth, temp, salt, dic, ta, pt, sit,
                                  lo, lo + 3.0, lo, lo + 3.0, depth > 10.0)


def test_step_with_pallas_raises_on_cpu():
    """carbonate_impl='pallas' asks for the compiled kernel."""
    from ocean_bgc.models.coupled import step
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.synthetic import synthetic_world

    state, grid, forcing = synthetic_world(nlev=3, ncol=4, seed=5,
                                           dtype=jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        step(state, grid, forcing, ModelParams(), 3600.0,
             compute_diags=False, carbonate_impl="pallas")


def test_fp32_step_with_pallas_carbonate(pallas_interpret):
    """The full coupled fp32 step with carbonate_impl='pallas' stays close
    to the fp32 XLA step (interpret mode on CPU)."""
    from ocean_bgc.models.coupled import step
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.synthetic import synthetic_world

    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=81,
                                           ragged=True, dtype=jnp.float32)
    out_x, _ = step(state, grid, forcing, params, 3600.0,
                    compute_diags=False, carbonate_impl="xla")
    out_p, _ = step(state, grid, forcing, params, 3600.0,
                    compute_diags=False, carbonate_impl="pallas")
    a = np.asarray(out_x.bgc.tracers, np.float64)
    b = np.asarray(out_p.bgc.tracers, np.float64)
    for i in range(a.shape[1]):
        scale = np.abs(a[:, i]).max() + 1e-30
        np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale,
                                   atol=5e-4, err_msg=f"tracer {i}")
    assert out_p.bgc.tracers.dtype == jnp.float32


@pytest.mark.gpu
def test_pallas_compiled_matches_xla(gpu, rng):
    """The compiled kernel (not the interpreter) on a flagship-sized
    batch, against the XLA dual solve."""
    n = 60 * 8192
    depth, temp, salt, dic, ta, pt, sit = _world(rng, n)
    lo = jnp.full(n, 6.0, jnp.float32)
    hi = jnp.full(n, 9.0, jnp.float32)
    press = depth > 10.0
    a, b = jax.jit(co3_terms_dual)(depth, temp, salt, dic, ta, pt, sit,
                                   lo, hi, lo + 0.1, hi - 0.1, press)
    pa, pb, _ = jax.jit(co3_terms_dual_sat_pallas)(
        depth, temp, salt, dic, ta, pt, sit, lo, hi, lo + 0.1, hi - 0.1,
        press)
    _check_close(a + b, pa + pb, (n,))


@pytest.mark.gpu
def test_pallas_under_shard_map_vma(gpu):
    """pallas_call inside shard_map needs vma-annotated out_shapes.

    GPU only: the Pallas interpreter (the CPU stand-in) itself
    mishandles vma inside shard_map ("Primitive mul requires varying
    manual axes to match"), so this executes only where the kernel
    compiles.
    """
    from ocean_bgc.models.coupled import step
    from ocean_bgc.parallel import make_mesh, shard_world
    from ocean_bgc.parallel.sharding import _col_spec
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.synthetic import synthetic_world

    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=3, ncol=16, seed=9,
                                           ragged=False,
                                           dtype=jnp.float32)
    mesh = make_mesh(jax.devices()[:1])
    sstate, sgrid, sforcing = shard_world(state, grid, forcing, mesh)

    def local(s, g, f):
        out, _ = step(s, g, f, params, 3600.0, compute_diags=False,
                      carbonate_impl="pallas")
        return out

    specs = jax.tree.map(_col_spec, (state, grid, forcing))
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=specs,
                               out_specs=specs[0]))
    out = fn(sstate, sgrid, sforcing)
    ref, _ = step(state, grid, forcing, params, 3600.0,
                  compute_diags=False, carbonate_impl="pallas")
    np.testing.assert_allclose(np.asarray(out.bgc.tracers),
                               np.asarray(ref.bgc.tracers),
                               rtol=2e-5, atol=1e-6)
