"""Solver iteration statistics: warm starts halve iterations (the
reference's documented behavior, co2calc.F90:858-863)."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.carbonate import (carbonate_coeffs, comp_htotal,
                                     solve_htotal_stats, _to_mass_units)


def test_warm_start_halves_iterations(rng):
    n = 256
    depth = jnp.zeros(n)
    temp = jnp.asarray(rng.uniform(-1.8, 30.0, n))
    salt = jnp.asarray(rng.uniform(31.0, 38.0, n))
    dic_in = jnp.asarray(rng.uniform(1850.0, 2350.0, n))
    alk_in = jnp.asarray(rng.uniform(2100.0, 2450.0, n))
    po4 = jnp.asarray(rng.uniform(0.0, 3.0, n))
    sio3 = jnp.asarray(rng.uniform(0.0, 120.0, n))

    coeffs = carbonate_coeffs(depth, temp, salt, False)
    dic, ta, pt, sit = _to_mass_units(dic_in, alk_in, po4, sio3)

    # cold: reference-documented wide bracket [10^-9, 10^-6]
    h_cold, it_cold, conv_cold = solve_htotal_stats(
        coeffs, dic, ta, pt, sit, 10.0 ** (-9.0) * jnp.ones(n),
        10.0 ** (-6.0) * jnp.ones(n))
    assert bool(conv_cold.all())

    ph = -jnp.log10(h_cold)
    h_warm, it_warm, conv_warm = solve_htotal_stats(
        coeffs, dic, ta, pt, sit,
        10.0 ** (-(ph + 0.2)), 10.0 ** (-(ph - 0.2)))
    assert bool(conv_warm.all())

    np.testing.assert_allclose(np.asarray(h_warm), np.asarray(h_cold),
                               rtol=1e-4, atol=2e-10)
    mean_cold = float(jnp.mean(it_cold))
    mean_warm = float(jnp.mean(it_warm))
    # the reference documents ~12 cold / ~5 warm iterations
    assert mean_cold > 1.5 * mean_warm, (mean_cold, mean_warm)
    assert 3.0 <= mean_cold <= 25.0
    assert 1.0 <= mean_warm <= 10.0
