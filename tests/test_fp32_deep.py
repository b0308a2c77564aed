"""Deep-water qualification of the opt-in fp32 fast path (beyond the
6-level toy world of tests/test_fp32_trajectory.py: the deep branches —
lysocline, anoxic bottom, the deep particulate-flux decay toward the
f32 flush threshold — inside the f32 envelope gate).

Three gates on the SAME 60-level branch-firing world as the f64 flagship
acceptance gate (tests/test_deep_world.py::_deep_world):

1. every particulate bottom-cell branch fires under f32 at t=0, with the
   same branch signatures as f64 (lysocline no-burial, CaCO3 burial,
   NO3<5 sed-denitrif gate, anoxic other_remin, both bSi efficiencies);
2. the f32 trajectory stays inside the f64 model's own f32-epsilon
   perturbation envelope (the fp32 qualification methodology of
   tests/test_fp32_trajectory.py), now over deep ragged bathymetry with
   a shelf and a land column;
3. an explicit RANGE AUDIT of the decaying particulate flux chains
   (BGC_mod.F90:2242-2255, 2336-2365) against IEEE f32's ~1.2e-38
   normal floor (CLAUDE.md, "Numerics").  Every nonzero deep flux the
   f64 model produces must sit orders of magnitude above the flush threshold, and the f32
   run must not flush any flux the f64 model keeps materially nonzero.

Default horizon 24 steps; OCEAN_BGC_DEEP_STEPS_F32=96 (or more) for the
acceptance run.
"""

import dataclasses
import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.constants import LYSOCLINE_DEPTH
from ocean_bgc.models.coupled import run, step
from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCTracers as T
from ocean_bgc.utils.synthetic import synthetic_world
from tests.test_deep_world import _deep_world

NSTEPS = int(os.environ.get("OCEAN_BGC_DEEP_STEPS_F32", "24"))
DT = 3600.0
F32_EPS = 1.1920929e-07
F32_TINY = 1.1754944e-38          # smallest normal float32

FLUX_DIAGS = ("POC_FLUX_IN", "CaCO3_FLUX_IN", "SiO2_FLUX_IN",
              "dust_FLUX_IN", "P_iron_FLUX_IN")


def _cast32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _deep_worlds(ncol=8):
    """The f64 branch-firing deep world (shelf + land columns) and its
    f32 cast."""
    state, grid, forcing = _deep_world(ncol=ncol)
    kmax = np.asarray(grid.kmax).copy()
    kmax[6] = 12   # shelf
    kmax[7] = 0    # land
    grid = dataclasses.replace(grid, kmax=jnp.asarray(kmax))
    return ((state, grid, forcing),
            (_cast32(state), _cast32(grid), _cast32(forcing)))


def test_fp32_deep_bottom_branches_fire():
    (s64, g64, f64c), (s32, g32, f32c) = _deep_worlds()
    params = ModelParams()
    out = bgc_source_sink(s32.bgc.tracers, g32, f32c,
                          s32.bgc.ph_prev_3d, s32.bgc.ph_prev_alt_3d,
                          params.bgc, carbonate_impl="xla")
    kmax = np.asarray(g32.kmax)
    kb = kmax - 1
    zbot = np.asarray(g32.cell_bottom_depth)
    got = {k: np.asarray(out.diags[k]) for k in
           ("calcToSed", "SedDenitrif", "OtherRemin", "bsiToSed")}
    assert np.isfinite(np.asarray(out.tendencies)).all()
    assert zbot[kb[0], 0] > np.float32(LYSOCLINE_DEPTH)
    assert got["calcToSed"][kb[0], 0] == 0.0          # lysocline
    assert got["calcToSed"][kb[1], 1] > 0.0           # burial branch
    assert got["SedDenitrif"][kb[2], 2] > 0.0         # denitrif on
    assert got["SedDenitrif"][kb[3], 3] == 0.0        # NO3 gate closed
    assert got["OtherRemin"][kb[2], 2] > 0.0          # anoxic branch
    # both bSi burial efficiencies discriminate under f32: the burial
    # fraction of the bottom incoming flux in the high-flux column
    # (eff 0.2) must exceed the low-flux column's (eff 0.04) by ~5x
    # (same temperature profile => same in-cell decay factor)
    sio2_in = np.asarray(out.diags["SiO2_FLUX_IN"])
    frac4 = got["bsiToSed"][kb[4], 4] / sio2_in[kb[4], 4]
    frac5 = got["bsiToSed"][kb[5], 5] / sio2_in[kb[5], 5]
    assert frac4 > 0.0 and frac5 > 0.0
    assert frac4 / frac5 > 3.0, (frac4, frac5)


def test_fp32_deep_trajectory_within_perturbation_envelope():
    (s64, g64, f64c), (s32, g32, f32c) = _deep_worlds()
    params = ModelParams()

    final64, _ = jax.jit(
        lambda s: run(s, g64, f64c, params, DT, NSTEPS))(s64)
    final32, _ = jax.jit(
        lambda s: run(s, g32, f32c, params, DT, NSTEPS))(s32)
    pert = dataclasses.replace(
        s64, bgc=dataclasses.replace(
            s64.bgc, tracers=s64.bgc.tracers * (1.0 + F32_EPS)))
    final_p, _ = jax.jit(
        lambda s: run(s, g64, f64c, params, DT, NSTEPS))(pert)

    got = np.asarray(final32.bgc.tracers, np.float64)
    want = np.asarray(final64.bgc.tracers)
    yard = np.abs(np.asarray(final_p.bgc.tracers) - want)
    assert np.isfinite(got).all()
    for idx in range(T.CNT):
        mismatch = np.abs(got[:, idx] - want[:, idx]).max()
        scale = np.abs(want[:, idx]).max() + 1e-30
        # the fp32 qualification envelope (test_fp32_trajectory.py):
        # amplified single-perturbation response + 1% for continuous
        # rounding injection
        bound = 30.0 * yard[:, idx].max() + 1e-2 * scale + 1e-12
        assert mismatch <= bound, (
            f"tracer {idx}: fp32 deep mismatch {mismatch:.3e} exceeds "
            f"envelope {bound:.3e} (scale {scale:.3e})")
    for name in ("dms", "macros"):
        a = np.asarray(getattr(final32, name), np.float64)
        b = np.asarray(getattr(final64, name))
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)


def test_fp32_deep_flux_range_audit():
    """The decaying sflux/hflux chains vs the f32 flush threshold.

    (a) In the f64 truth, every flux the model treats as nonzero at any
        active deep cell sits >= 12 orders of magnitude above the f32
        normal floor — there is no physical regime where honest f32
        arithmetic flushes a LOAD-BEARING flux (the exponential decay
        lengths and bottom boundary conditions keep fluxes either
        O(1e-12+) or exactly zero).
    (b) The f32 run agrees: wherever the f64 flux is materially nonzero
        (> 1e-12 of that flux's own maximum), the f32 flux is nonzero
        too — no silent flush-to-zero divergence after NSTEPS steps of
        deep decay.
    """
    (s64, g64, f64c), (s32, g32, f32c) = _deep_worlds()
    params = ModelParams()

    st64, st32 = s64, s32
    run64 = jax.jit(lambda s: run(s, g64, f64c, params, DT, NSTEPS - 1))
    run32 = jax.jit(lambda s: run(s, g32, f32c, params, DT, NSTEPS - 1))
    st64, _ = run64(st64)
    st32, _ = run32(st32)
    _, d64 = step(st64, g64, f64c, params, DT, compute_diags=True)
    _, d32 = step(st32, g32, f32c, params, DT, compute_diags=True)

    active = np.asarray(g64.active_mask())
    for name in FLUX_DIAGS:
        a64 = np.asarray(d64[name])[active]
        a32 = np.asarray(d32[name], np.float64)[active]
        assert np.isfinite(a32).all(), name
        nz = a64 > 0.0
        if nz.any():
            floor = a64[nz].min()
            assert floor > 1e12 * F32_TINY, (
                f"{name}: smallest nonzero f64 flux {floor:.3e} is "
                f"within 12 decades of the f32 flush threshold")
        material = a64 > 1e-12 * (a64.max() + 1e-300)
        flushed = material & (a32 == 0.0)
        assert not flushed.any(), (
            f"{name}: {flushed.sum()} cells flushed to zero under f32 "
            f"where f64 keeps a material flux")
