"""Qualification of the opt-in fast-f64 solver path (OBGC_FAST_F64=1).

talk_fast re-associates the TA residual's reciprocals (four divisions
instead of eight) and is mathematically identical to talk().  It is
NOT the bitwise f64 contract path: reassociation shifts results by ~1e-15 relative, which perturbs
the Newton iterate sequence inside the solver tolerance.  Qualified here
with the same perturbation-envelope methodology as the fp32 fast path
(tests/test_fp32_trajectory.py).
"""

import dataclasses
import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import run
from ocean_bgc.ops.carbonate import (
    carbonate_coeffs,
    solve_htotal,
    talk,
    talk_fast,
)
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS_FAST64", "96"))
DT = 3600.0


def _random_cells(rng, n=4096):
    depth_m = jnp.asarray(rng.uniform(0.0, 5000.0, n))
    temp = jnp.asarray(rng.uniform(-1.8, 31.0, n))
    salt = jnp.asarray(rng.uniform(30.0, 40.0, n))
    coeffs = carbonate_coeffs(depth_m, temp, salt, depth_m > 10.0,
                              k1_k2_ph_tot=True)
    dic = jnp.asarray(rng.uniform(1.8e-3, 2.4e-3, n))     # mol/kg
    ta = jnp.asarray(rng.uniform(2.0e-3, 2.5e-3, n))
    pt = jnp.asarray(rng.uniform(0.0, 3.5e-6, n))
    sit = jnp.asarray(rng.uniform(0.0, 1.5e-4, n))
    return coeffs, dic, ta, pt, sit


def test_talk_fast_matches_talk_to_reassociation_ulps(rng):
    coeffs, dic, ta, pt, sit = _random_cells(rng)
    for ph in (6.0, 7.4, 8.1, 9.0):
        h = jnp.full(dic.shape, 10.0 ** (-ph))
        fn_a, df_a = talk(coeffs, dic, ta, pt, sit, h)
        fn_b, df_b = talk_fast(coeffs, dic, ta, pt, sit, h)
        # fn is a near-cancelling sum at the root; compare against the
        # magnitude of its largest term (the TA itself) instead of the
        # residual value
        np.testing.assert_allclose(np.asarray(fn_b), np.asarray(fn_a),
                                   rtol=0.0,
                                   atol=1e-12 * float(np.abs(ta).max()))
        np.testing.assert_allclose(np.asarray(df_b), np.asarray(df_a),
                                   rtol=1e-12)


def test_fast_f64_solver_same_root(rng, monkeypatch):
    """The fast path converges to the same H (within the solver's own
    xacc stopping rule; empirically far tighter)."""
    coeffs, dic, ta, pt, sit = _random_cells(rng, n=2048)
    x1 = jnp.full(dic.shape, 10.0 ** (-9.0))
    x2 = jnp.full(dic.shape, 10.0 ** (-6.0))

    monkeypatch.setenv("OBGC_FAST_F64", "0")
    h_exact = np.asarray(solve_htotal(coeffs, dic, ta, pt, sit, x1, x2))
    monkeypatch.setenv("OBGC_FAST_F64", "1")
    h_fast = np.asarray(solve_htotal(coeffs, dic, ta, pt, sit, x1, x2))

    # formal bound: both stop within xacc=1e-10 of the root
    np.testing.assert_allclose(h_fast, h_exact, rtol=0.0, atol=2e-10)
    # empirical: Newton's quadratic tail makes them match much tighter
    np.testing.assert_allclose(h_fast, h_exact, rtol=1e-6)


def test_fast_f64_trajectory_within_perturbation_envelope(monkeypatch):
    """The fast-f64 trajectory diverges from the contract path by no
    more than the model's own response to a 1-ulp initial perturbation
    (times margin) — rounding behaves like a tiny IC perturbation, not
    a bias."""
    nlev, ncol = 6, 8
    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol, seed=47,
                                           ragged=False)
    params = ModelParams()

    monkeypatch.setenv("OBGC_FAST_F64", "0")
    exact, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(state)
    pert0 = dataclasses.replace(
        state, bgc=dataclasses.replace(
            state.bgc, tracers=state.bgc.tracers * (1.0 + 1e-15)))
    pert, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(pert0)

    monkeypatch.setenv("OBGC_FAST_F64", "1")
    fast, _ = jax.jit(
        lambda s: run(s, grid, forcing, params, DT, NSTEPS))(state)

    want = np.asarray(exact.bgc.tracers)
    got = np.asarray(fast.bgc.tracers)
    yard = np.abs(np.asarray(pert.bgc.tracers) - want)
    assert np.isfinite(got).all()
    for idx in range(T.CNT):
        mismatch = np.abs(got[:, idx] - want[:, idx]).max()
        bound = 100.0 * yard[:, idx].max() + 1e-13 * np.abs(
            want[:, idx]).max() + 1e-18
        assert mismatch <= bound, (
            f"tracer {idx}: fast-f64 mismatch {mismatch:.3e} exceeds "
            f"perturbation envelope {bound:.3e}")


def test_talk_fast_pair_products_within_f32_exponent_range(rng):
    """Every intermediate stays inside float32's ~1e+/-38 exponent range
    (CLAUDE.md, "Numerics"; a combined product of all 8 TA denominators,
    ~1e-65, would leave it).  Pin that every _paired_reciprocal product
    stays within [1e-37, 1e37] over the full coefficient envelope and
    the widest bracket state the solver can reach, so the suite catches
    any re-pairing that would leave the range."""
    coeffs, dic, ta, pt, sit = _random_cells(rng, n=8192)
    lo, hi = 1e-37, 1e37
    for ph in (5.0, 6.0, 7.0, 8.0, 9.0, 10.5, 11.0):
        h = np.full(dic.shape, 10.0 ** (-ph))
        k12p = np.asarray(coeffs.k1p * coeffs.k2p)
        k123p = k12p * np.asarray(coeffs.k3p)
        phos_den = (h ** 3 + np.asarray(coeffs.k1p) * h ** 2
                    + k12p * h + k123p)
        carb_den = (h ** 2 + np.asarray(coeffs.k1) * h
                    + np.asarray(coeffs.k1 * coeffs.k2))
        pairs = {
            "h*hso4_den": h * (h + np.asarray(coeffs.ks + coeffs.st)),
            "phos*scale": phos_den * np.asarray(coeffs.ks + coeffs.st),
            "carb*hf": carb_den * (h + np.asarray(coeffs.kf)),
            "borate*sili": ((np.asarray(coeffs.kb) + h)
                            * (np.asarray(coeffs.ksi) + h)),
        }
        for name, prod in pairs.items():
            assert (prod > lo).all() and (prod < hi).all(), (
                f"pair {name} leaves the float32 exponent range at "
                f"pH {ph}: [{prod.min():.3e}, {prod.max():.3e}]")


def test_fast_f64_off_is_bitwise_default(monkeypatch):
    """With the flag off (the default), the solver is bit-identical to
    the contract path — the fast path cannot leak in."""
    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=3,
                                           ragged=True)
    params = ModelParams()
    monkeypatch.delenv("OBGC_FAST_F64", raising=False)
    a, _ = jax.jit(lambda s: run(s, grid, forcing, params, DT, 3))(state)
    monkeypatch.setenv("OBGC_FAST_F64", "0")
    b, _ = jax.jit(lambda s: run(s, grid, forcing, params, DT, 3))(state)
    np.testing.assert_array_equal(np.asarray(a.bgc.tracers),
                                  np.asarray(b.bgc.tracers))


def test_no_sub_emulation_range_literals_in_compute_path():
    """Every intermediate stays inside float32's exponent range
    (CLAUDE.md, "Numerics"): any literal below ~1e-38 is EXACTLY ZERO in
    float32.  A 1e-300 floor under the nitrification-taper log was once
    such a bug — its flush sent every BGC parameter gradient to NaN
    while float64 runs stayed finite.  Float64 tests cannot see it, so
    pin the invariant at the source level: no numeric literal in the
    differentiable compute path may lie below that range."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "ocean_bgc"
    offenders = []
    for f in sorted(list(root.glob("ops/*.py"))
                    + list(root.glob("models/*.py"))):
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, float)
                    and 0.0 < abs(node.value) < 1e-37):
                offenders.append(
                    f"{f.name}:{node.lineno}: {node.value!r}")
    assert not offenders, offenders
