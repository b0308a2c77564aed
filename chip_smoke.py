"""Smoke test of the column model on NVIDIA GPUs.

    python chip_smoke.py               # phases 0-3, one card
    python chip_smoke.py --four-cards  # phase 4 only, four cards

Phase 0  the device: a GPU, or the script stops before any compile.
Phase 1  the main path at the flagship width (60 levels x 8,192 ragged
         columns, float64, BGC+DMS+MACROS+co2calc, env cache on):
         ``run_model`` with history, checkpoints and health counters,
         then a restore; then timed ``step`` calls at 8,192 columns and
         at 122,880 columns (the column count of the 1-degree POP grid).
Phase 2  agreement of the full-width GPU run, on a 32-column subset of
         shelf, deep and land columns, with the same program on the CPU
         backend and with the float64 scalar oracle (tests/oracle).
Phase 3  the float32 path: the default step (the Pallas carbonate
         kernel) against the XLA one, the compiled kernel against the
         XLA dual solve on 491,520 cells and inside ``shard_map``, and a
         24-step deep-world trajectory against CPU float32.
Phase 4  ``make_sharded_step`` over four cards against the one-card
         step, and ``run_model --sharded`` with a checkpoint and restore.

A failed check raises, so the script exits non-zero and prints no result
line.  The last line of standard output is one JSON object naming the
device.  Every time printed carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NLEV = 60
NCOL = 8192            # flagship width
NCOL_GX1 = 122880      # 320 x 384 columns of the 1-degree POP grid
NCOL_MESH = 32768      # four cards x 8,192 columns
DT = 3600.0

# Tolerances, each with its reason.
# GPU vs CPU, one step of BGC tendencies, per tracer relative to the
# tracer's largest magnitude: the same program, but the GPU's exp/log and
# FMA contraction differ from XLA:CPU's in the last bits, and the pH
# solver carries those bits, not more (the oracle pin below is 1e-9).
TOL_TEND_CPU = 1e-10
# GPU vs the scalar oracle, one step of BGC tendencies: the pin of
# tests/test_deep_world.py::test_deep_bottom_branches_match_oracle.
TOL_TEND_ORACLE = dict(rtol=1e-9, atol=1e-22)
# GPU vs the oracle after a few steps: the short-horizon gate of
# tests/test_deep_world.py (carbonate tracers carry the solver's xacc).
TOL_TRAJ_ORACLE_CARB = dict(rtol=2e-4, atol=1e-10)
TOL_TRAJ_ORACLE = dict(rtol=5e-7, atol=1e-18)
# GPU vs CPU after 24 steps: the perturbation envelope of
# tests/test_deep_world.py — 10x the spread a 1e-15 relative kick
# produces on the CPU, plus 2e-4 of the tracer's scale.
ENVELOPE_YARD, ENVELOPE_REL, PERTURB = 10.0, 2e-4, 1e-15
# float32 kernel vs the XLA float32 dual solve: the bound of
# tests/test_pallas_carbonate.py (error over the field's largest value).
TOL_KERNEL = 3e-4
# the kernel inside a one-device shard_map vs outside it: the same
# compiled kernel on the same cells; XLA may fuse the rest differently.
TOL_SHARD_MAP = dict(rtol=2e-5, atol=1e-6)
# float32 deep world, GPU vs CPU after 24 steps: the envelope of the
# float32 gates (tests/test_fp32_deep.py) — 30x the spread of an f32-eps
# kick on the CPU, plus 1e-2 of the tracer's scale.
F32_YARD, F32_REL, F32_EPS = 30.0, 1e-2, 1.1920929e-07
# four cards vs one: the same step compiled for another batch width
# (compile-variant ulps, as TOL_TEND_CPU).  The psum'd production totals
# agree to 1e-12 relative with a float64 host sum of the same columns and
# with the one-card sums.  The Jint_* fields are conservation residuals:
# each column's value is roundoff noise (~1e-17) that any change of
# fusion redraws, so a relative comparison means nothing there; every
# such sum must be conserved instead (|sum| < 1e-10, the run_model
# summary's bound).
TOL_MESH = 1e-10
TOL_GLOBAL_SUM = 1e-12
TOL_JINT = 1e-10


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def say(msg):
    print(msg, flush=True)


def timed(label, seconds, card_tag, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    say(f"  {label}: {seconds:.6f} s {fields} [{card_tag}]")


def worst_rel(got, want, axis_tracer=1):
    """Largest |got - want| over each tracer's largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    worst = 0.0
    for i in range(want.shape[axis_tracer]):
        w = np.take(want, i, axis=axis_tracer)
        g = np.take(got, i, axis=axis_tracer)
        scale = np.abs(w).max()
        if scale == 0.0:
            assert np.abs(g).max() == 0.0, f"tracer {i}: nonzero vs zero"
            continue
        worst = max(worst, float(np.abs(g - w).max() / scale))
    return worst


def run_cli(argv):
    """ocean_bgc.run_model.main(argv); returns its JSON summary."""
    from ocean_bgc import run_model
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_model.main(argv)
    assert rc == 0, rc
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    say(f"  run_model {' '.join(argv)}\n    -> {json.dumps(summary)}")
    return summary


def check_summary(s):
    assert s["finite"], s
    assert abs(s["max_abs_Jint_Ctot"]) < 1e-10, s
    assert s["health_solver_nonconverged_cells_total"] == 0.0, s
    assert s["health_poc_error_cells_total"] == 0.0, s


def timed_step(jax, step_fn, state, grid, forcing, env, nsteps, repeats,
               card_tag, label):
    """Compile step_fn for these shapes, time it, return the compiled
    program and the state after the warm-up step."""
    t0 = time.perf_counter()
    comp = jax.jit(step_fn).lower(state, grid, forcing, env).compile()
    t_compile = time.perf_counter() - t0
    s, d = comp(state, grid, forcing, env)
    jax.block_until_ready(s)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(nsteps):
            s, d = comp(s, grid, forcing, env)
        jax.block_until_ready(s)
        best = min(best, (time.perf_counter() - t0) / nsteps)
    ncol = state.bgc.ncol
    timed(f"{label} compile", t_compile, card_tag)
    timed(f"{label} step", best, card_tag,
          columns_per_s=f"{ncol / best:.1f}")
    assert np.isfinite(np.asarray(s.bgc.tracers)).all(), label
    for k, v in d.items():
        assert float(v) == 0.0, (label, k, float(v))
    return comp


def phase1(jax, ctx):
    from ocean_bgc.models.coupled import step
    from ocean_bgc.ops.bgc import precompute_env
    from ocean_bgc.ops.carbonate import (_to_mass_units,
                                         solve_htotal_stats,
                                         warm_brackets_h)
    from ocean_bgc import constants as c
    from ocean_bgc.state import BGCTracers as T
    from ocean_bgc.utils import checkpoint as ckpt
    from ocean_bgc.utils.synthetic import synthetic_world

    say(f"  checkpoint route: {'orbax' if ckpt._HAS_ORBAX else 'npz'}")
    with tempfile.TemporaryDirectory() as d:
        base = ["--nlev", str(NLEV), "--ncol", str(NCOL), "--health",
                "--quiet"]
        s1 = run_cli(base + ["--steps", "24", "--history-every", "12",
                             "--checkpoint-every", "12", "--out", d])
        check_summary(s1)
        hist = sorted(f for f in os.listdir(d) if f.startswith("hist_"))
        assert len(hist) == 2, hist
        s2 = run_cli(base + ["--steps", "4", "--restore",
                             os.path.join(d, "ck_000024"),
                             "--out", os.path.join(d, "resumed")])
        check_summary(s2)

    params = ctx["params"]
    env_fn = jax.jit(precompute_env, static_argnums=2)

    def step_fn(s, g, f, env):
        return step(s, g, f, params, DT, compute_diags=False, env=env,
                    health=True)

    for ncol, nsteps, repeats in ((NCOL, 10, 3), (NCOL_GX1, 2, 1)):
        state, grid, forcing = synthetic_world(nlev=NLEV, ncol=ncol,
                                               seed=0, ragged=True)
        env = env_fn(grid, forcing, params.bgc)
        comp = timed_step(jax, step_fn, state, grid, forcing, env, nsteps,
                          repeats, ctx["card"],
                          f"f64 step {NLEV}x{ncol} ragged, env on")
        if ncol == NCOL:
            ctx["f64"] = (state, grid, forcing, env, comp)
        del state, grid, forcing, env, comp

    # the pH solver's trip counts after a few warm steps: every trip of
    # the batch-wide while_loop is one more predicate read on the host
    state, grid, forcing, env, comp = ctx["f64"]
    s = state
    for _ in range(3):
        s, _ = comp(s, grid, forcing, env)
    act = grid.active_mask()
    ph = jax.numpy.where(act, s.bgc.ph_prev_3d, env.standin_ph)
    x1, x2 = warm_brackets_h(ph, c.PHLO_3D_INIT, c.PHHI_3D_INIT, c.DEL_PH)
    tr = s.bgc.tracers
    jnp = jax.numpy
    dic, ta, pt, sit = _to_mass_units(
        jnp.where(act, tr[:, T.DIC], 2000.0),
        jnp.where(act, tr[:, T.ALK], 2300.0), tr[:, T.PO4], tr[:, T.SIO3])
    _, iters, conv = jax.jit(solve_htotal_stats)(env.coeffs, dic, ta, pt,
                                                 sit, x1, x2)
    iters = np.asarray(iters)
    assert np.asarray(conv).all()
    say(f"  pH solver trips per cell (warm, interior): max {iters.max()}, "
        f"mean {iters.mean():.3f}, histogram "
        f"{np.bincount(iters.ravel()).tolist()}")


def subset_columns(kmax):
    """32 columns: land, shelf and deep, from the full-width world."""
    land = np.flatnonzero(kmax == 0)[:4]
    shelf = np.flatnonzero((kmax > 0) & (kmax < NLEV))[:12]
    deep = np.flatnonzero(kmax == NLEV)[:32 - len(land) - len(shelf)]
    assert len(land) and len(shelf) and len(deep)
    return np.sort(np.concatenate([land, shelf, deep]))


def take_cols(jax, tree, cols):
    return jax.tree.map(lambda x: np.asarray(x)[..., cols], tree)


def phase2(jax, ctx):
    from ocean_bgc.models.coupled import step
    from ocean_bgc.ops.bgc import bgc_source_sink, precompute_env
    from ocean_bgc.state import BGCTracers as T
    from tests.oracle import bgc_ref
    from tests.oracle.coupled_ref import coupled_step_ref

    params = ctx["params"]
    cpu = jax.devices("cpu")[0]
    state, grid, forcing, env, comp = ctx["f64"]
    kmax = np.asarray(grid.kmax)
    cols = subset_columns(kmax)
    say(f"  subset: {len(cols)} columns, kmax {sorted(set(kmax[cols]))}")
    s_c, g_c, f_c = (jax.device_put(take_cols(jax, t, cols), cpu)
                     for t in (state, grid, forcing))

    def tend_fn(tr, g, f, ph, pha):
        return bgc_source_sink(tr, g, f, ph, pha, params.bgc,
                               compute_diags=False).tendencies

    tend_gpu = np.asarray(jax.jit(tend_fn)(
        state.bgc.tracers, grid, forcing, state.bgc.ph_prev_3d,
        state.bgc.ph_prev_alt_3d))[..., cols]
    tend_cpu = np.asarray(jax.jit(tend_fn)(
        s_c.bgc.tracers, g_c, f_c, s_c.bgc.ph_prev_3d,
        s_c.bgc.ph_prev_alt_3d))
    err = worst_rel(tend_gpu, tend_cpu)
    say(f"  1 step, BGC tendencies, GPU vs CPU: worst {err:.3e} "
        f"(tolerance {TOL_TEND_CPU:.0e} of each tracer's scale)")
    assert err <= TOL_TEND_CPU

    def gdict(g):
        return {k: np.asarray(getattr(g, k)) for k in (
            "cell_center_depth", "cell_thickness", "cell_bottom_depth",
            "latitude", "kmax")}

    def fdict(f):
        return {k.name: np.asarray(getattr(f, k.name))
                for k in dataclasses.fields(f)}

    # the oracle is scalar Python: a few columns of each kind
    land = cols[kmax[cols] == 0][:1]
    shelf = cols[(kmax[cols] > 0) & (kmax[cols] < NLEV)][:2]
    deep = cols[kmax[cols] == NLEV][:2]
    oc = np.concatenate([land, shelf, deep])
    pos = np.searchsorted(cols, oc)
    s_o, g_o, f_o = (take_cols(jax, t, oc) for t in (state, grid, forcing))
    want, _, _, _ = bgc_ref.bgc_source_sink_ref(
        s_o.bgc.tracers, gdict(g_o), fdict(f_o), s_o.bgc.ph_prev_3d,
        s_o.bgc.ph_prev_alt_3d, params.bgc)
    np.testing.assert_allclose(tend_gpu[..., pos], want,
                               **TOL_TEND_ORACLE)
    say(f"  1 step, BGC tendencies, GPU vs oracle on {len(oc)} columns: "
        f"within rtol {TOL_TEND_ORACLE['rtol']:.0e}, "
        f"atol {TOL_TEND_ORACLE['atol']:.0e}")

    # trajectories: 24 steps on the GPU at full width, on the CPU on the
    # subset, and on the CPU from a 1e-15 kick (the envelope's yardstick)
    nsteps, n_oracle = 24, 3
    s = state
    for i in range(nsteps):
        s, _ = comp(s, grid, forcing, env)
        if i + 1 == n_oracle:
            s_at_oracle = take_cols(jax, s, oc)
    got = np.asarray(s.bgc.tracers)[..., cols]

    env_c = jax.jit(precompute_env, static_argnums=2)(g_c, f_c,
                                                      params.bgc)

    def step_fn(s, g, f, env):
        return step(s, g, f, params, DT, compute_diags=False, env=env,
                    health=True)

    comp_c = jax.jit(step_fn).lower(s_c, g_c, f_c, env_c).compile()

    def cpu_run(s0):
        for _ in range(nsteps):
            s0, _ = comp_c(s0, g_c, f_c, env_c)
        return np.asarray(s0.bgc.tracers)

    want = cpu_run(s_c)
    kicked = dataclasses.replace(s_c, bgc=dataclasses.replace(
        s_c.bgc, tracers=s_c.bgc.tracers * (1.0 + PERTURB)))
    yard = np.abs(cpu_run(kicked) - want)
    worst = 0.0
    for i in range(T.CNT):
        bound = (ENVELOPE_YARD * yard[:, i].max()
                 + ENVELOPE_REL * np.abs(want[:, i]).max() + 1e-12)
        mismatch = np.abs(got[:, i] - want[:, i]).max()
        worst = max(worst, float(mismatch / bound))
        assert mismatch <= bound, (i, mismatch, bound)
    say(f"  {nsteps} steps, tracers, GPU vs CPU: worst mismatch "
        f"{worst:.3e} of the envelope ({ENVELOPE_YARD:g} x the spread of "
        f"a {PERTURB:g} kick + {ENVELOPE_REL:g} of scale)")

    ostate = dict(
        tracers=s_o.bgc.tracers, ph_prev=s_o.bgc.ph_prev_3d,
        ph_prev_alt=s_o.bgc.ph_prev_alt_3d,
        surface_ph=s_o.bgc.surface_ph, surface_ph_alt=s_o.bgc.surface_ph_alt,
        dms=s_o.dms, macros=s_o.macros)
    for _ in range(n_oracle):
        ostate = coupled_step_ref(ostate, gdict(g_o), fdict(f_o), params,
                                  DT)
    carb = (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK)
    for i in range(T.CNT):
        tol = TOL_TRAJ_ORACLE_CARB if i in carb else TOL_TRAJ_ORACLE
        np.testing.assert_allclose(s_at_oracle.bgc.tracers[:, i],
                                   ostate["tracers"][:, i], **tol,
                                   err_msg=f"tracer {i}")
    np.testing.assert_allclose(s_at_oracle.dms, ostate["dms"],
                               **TOL_TRAJ_ORACLE)
    np.testing.assert_allclose(s_at_oracle.macros, ostate["macros"],
                               **TOL_TRAJ_ORACLE)
    say(f"  {n_oracle} steps, GPU vs oracle on {len(oc)} columns: within "
        f"rtol {TOL_TRAJ_ORACLE_CARB['rtol']:g} (DIC, DIC_ALT, O2, ALK) "
        f"and {TOL_TRAJ_ORACLE['rtol']:g} (all else)")


def phase3(jax, ctx):
    jnp = jax.numpy
    from ocean_bgc.models.coupled import run, step
    from ocean_bgc.ops.bgc import precompute_env, resolve_carbonate_impl
    from ocean_bgc.ops.carbonate import (carbonate_coeffs, co3_sat_vals,
                                         co3_terms_dual)
    from ocean_bgc.ops.pallas_carbonate import co3_terms_dual_sat_pallas
    from ocean_bgc.parallel import make_mesh
    from ocean_bgc.parallel.sharding import _col_spec
    from ocean_bgc.utils.synthetic import synthetic_world
    from tests.test_fp32_deep import FLUX_DIAGS, _deep_worlds

    params = ctx["params"]
    f32 = jnp.float32
    assert resolve_carbonate_impl("auto", f32) == "pallas"
    state, grid, forcing = synthetic_world(nlev=NLEV, ncol=NCOL, seed=0,
                                           ragged=True, dtype=f32)
    env = jax.jit(precompute_env, static_argnums=2)(grid, forcing,
                                                    params.bgc)
    for impl in ("auto", "xla"):
        def step_fn(s, g, f, env, impl=impl):
            return step(s, g, f, params, DT, compute_diags=False, env=env,
                        carbonate_impl=impl)
        timed_step(jax, step_fn, state, grid, forcing, env, 10, 3,
                   ctx["card"], f"f32 step {NLEV}x{NCOL} ragged, env on, "
                   f"carbonate {resolve_carbonate_impl(impl, f32)}")

    # the compiled kernel against the XLA dual solve on every cell
    n = NLEV * NCOL
    rng = np.random.default_rng(7)
    depth, temp, salt, dic, ta, pt, sit = (
        jnp.asarray(rng.uniform(lo, hi, n), f32) for lo, hi in
        ((0, 5000), (-1.8, 31), (30, 40), (1800, 2400), (2000, 2500),
         (0, 3.5), (0, 150)))
    lo, hi = jnp.full(n, 6.0, f32), jnp.full(n, 9.0, f32)
    press = depth > 10.0
    ref = jax.jit(lambda *a: co3_terms_dual(*a))(
        depth, temp, salt, dic, ta, pt, sit, lo, hi, lo + 0.1, hi - 0.1,
        press)
    sat = jax.jit(co3_sat_vals)(depth, temp, salt, press)
    coeffs = jax.jit(carbonate_coeffs)(depth, temp, salt, press)
    for label, kw in (("in-kernel coefficients", {}),
                      ("cached coefficients",
                       dict(coeffs=coeffs, with_sat=False))):
        pa, pb, psat = jax.jit(
            lambda *a, kw=kw: co3_terms_dual_sat_pallas(*a, **kw))(
            depth, temp, salt, dic, ta, pt, sit, lo, hi, lo + 0.1,
            hi - 0.1, press)
        pairs = list(zip(ref[0] + ref[1], pa + pb))
        if psat is not None:
            pairs += list(zip(sat, psat))
        err = max(float(np.abs(np.asarray(g, np.float64)
                               - np.asarray(r, np.float64)).max()
                        / np.abs(np.asarray(r, np.float64)).max())
                  for r, g in pairs)
        say(f"  kernel ({label}) vs XLA dual solve on {n} cells: worst "
            f"{err:.3e} of scale (tolerance {TOL_KERNEL:g})")
        assert err <= TOL_KERNEL

    # the kernel inside a one-device shard_map (vma-annotated outputs)
    mesh = make_mesh(jax.devices()[:1])
    specs = jax.tree.map(_col_spec, (state, grid, forcing))

    def local(s, g, f):
        return step(s, g, f, params, DT, compute_diags=False,
                    carbonate_impl="pallas")[0]

    out = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=specs,
                                out_specs=specs[0]))(state, grid, forcing)
    plain = jax.jit(local)(state, grid, forcing)
    np.testing.assert_allclose(np.asarray(out.bgc.tracers),
                               np.asarray(plain.bgc.tracers),
                               **TOL_SHARD_MAP)
    say(f"  kernel inside a 1-device shard_map: equal to the plain step "
        f"within rtol {TOL_SHARD_MAP['rtol']:g}")

    # float32 deep branch-firing world: GPU (kernel) vs CPU (XLA)
    nsteps = 24
    (_, _, _), (s32, g32, f32c) = _deep_worlds()
    cpu = jax.devices("cpu")[0]

    # "auto" keys on the default backend (the GPU), so the CPU leg names
    # its carbonate path itself
    def make_trajectory(impl):
        run_fn = jax.jit(lambda s, g, f: run(s, g, f, params, DT,
                                             nsteps - 1,
                                             carbonate_impl=impl))
        diag_fn = jax.jit(lambda s, g, f: step(
            s, g, f, params, DT, compute_diags=True,
            carbonate_impl=impl)[1])

        def trajectory(s, g, f, device):
            s, g, f = jax.device_put((s, g, f), device)
            final, _ = run_fn(s, g, f)
            return final, diag_fn(final, g, f)
        return trajectory

    final, diags = make_trajectory("auto")(s32, g32, f32c,
                                           jax.devices()[0])
    trajectory = make_trajectory("xla")
    fin_c, diags_c = trajectory(s32, g32, f32c, cpu)
    got = np.asarray(final.bgc.tracers, np.float64)
    want = np.asarray(fin_c.bgc.tracers, np.float64)
    assert np.isfinite(got).all()
    kmax = np.asarray(g32.kmax)
    kb = kmax - 1
    gd = {k: np.asarray(diags[k]) for k in
          ("calcToSed", "SedDenitrif", "OtherRemin")}
    assert gd["calcToSed"][kb[0], 0] == 0.0        # lysocline
    assert gd["calcToSed"][kb[1], 1] > 0.0         # burial
    assert gd["SedDenitrif"][kb[3], 3] == 0.0      # NO3 gate
    assert gd["OtherRemin"][kb[2], 2] > 0.0        # anoxic bottom
    active = np.asarray(g32.active_mask())
    for name in FLUX_DIAGS:
        a_g = np.asarray(diags[name], np.float64)[active]
        a_c = np.asarray(diags_c[name], np.float64)[active]
        assert np.isfinite(a_g).all(), name
        material = a_c > 1e-12 * (a_c.max() + 1e-300)
        assert not (material & (a_g == 0.0)).any(), f"{name} flushed"
    kicked = dataclasses.replace(s32, bgc=dataclasses.replace(
        s32.bgc, tracers=s32.bgc.tracers * np.float32(1.0 + F32_EPS)))
    fin_k, _ = trajectory(kicked, g32, f32c, cpu)
    yard = np.abs(np.asarray(fin_k.bgc.tracers, np.float64) - want)
    worst = 0.0
    for i in range(got.shape[1]):
        bound = (F32_YARD * yard[:, i].max()
                 + F32_REL * (np.abs(want[:, i]).max() + 1e-30) + 1e-12)
        mismatch = np.abs(got[:, i] - want[:, i]).max()
        worst = max(worst, float(mismatch / bound))
        assert mismatch <= bound, (i, mismatch, bound)
    say(f"  f32 deep world, {nsteps} steps, GPU vs CPU: branches fire, no "
        f"flux flushed, worst mismatch {worst:.3e} of the envelope")


def phase4(jax, ctx):
    from ocean_bgc.models.coupled import step
    from ocean_bgc.parallel import make_mesh, make_sharded_step, shard_world
    from ocean_bgc.parallel.sharding import GLOBAL_SUM_DIAGS, HEALTH_DIAGS
    from ocean_bgc.utils.synthetic import synthetic_world

    params = ctx["params"]
    devs = jax.devices()
    assert len(devs) == 4, devs
    state, grid, forcing = synthetic_world(nlev=NLEV, ncol=NCOL_MESH,
                                           seed=0, ragged=True)
    mesh = make_mesh(devs)
    sharded = shard_world(state, grid, forcing, mesh)
    fn = make_sharded_step(mesh, params, DT, compute_diags=True,
                           health=True, local_diags=GLOBAL_SUM_DIAGS)
    t0 = time.perf_counter()
    comp = fn.lower(*sharded).compile()
    timed(f"sharded step {NLEV}x{NCOL_MESH} compile",
          time.perf_counter() - t0, ctx["card"])
    new_state, global_diags, local = comp(*sharded)
    jax.block_until_ready(new_state)
    t0 = time.perf_counter()
    for _ in range(5):
        s2, _, _ = comp(*sharded)
    jax.block_until_ready(s2)
    sec = (time.perf_counter() - t0) / 5
    timed(f"sharded step {NLEV}x{NCOL_MESH}", sec, ctx["card"],
          columns_per_s=f"{NCOL_MESH / sec:.1f}", cards=4)

    one = jax.device_put((state, grid, forcing), devs[0])
    ref_state, ref_diags = jax.jit(
        lambda s, g, f: step(s, g, f, params, DT, compute_diags=True,
                             health=True))(*one)
    err = worst_rel(new_state.bgc.tracers, ref_state.bgc.tracers)
    say(f"  four cards vs one card, tracers after 1 step: worst {err:.3e} "
        f"(tolerance {TOL_MESH:.0e} of each tracer's scale)")
    assert err <= TOL_MESH
    for name in GLOBAL_SUM_DIAGS:
        terms = np.asarray(local[name], np.float64)
        got = float(global_diags[name])
        host = float(np.sum(terms))
        scale = float(np.sum(np.abs(terms)))
        one_card = float(np.sum(np.asarray(ref_diags[name], np.float64)))
        say(f"  psum {name}: {got!r}; host sum of the same columns "
            f"{host!r}; one card {one_card!r}")
        if name.startswith("Jint_"):
            assert max(abs(got), abs(host), abs(one_card)) < TOL_JINT, name
        else:
            assert abs(got - host) <= TOL_GLOBAL_SUM * scale, name
            assert abs(got - one_card) <= TOL_GLOBAL_SUM * scale, name
    for name in HEALTH_DIAGS:
        assert float(global_diags[name]) == float(ref_diags[name]), name
    say("  health counters equal to the one-card counts")

    with tempfile.TemporaryDirectory() as d:
        base = ["--sharded", "--nlev", str(NLEV), "--ncol", str(NCOL_MESH),
                "--health", "--quiet"]
        check_summary(run_cli(base + ["--steps", "4", "--checkpoint-every",
                                      "2", "--out", d]))
        check_summary(run_cli(base + ["--steps", "2", "--restore",
                                      os.path.join(d, "ck_000004"),
                                      "--out", os.path.join(d, "r")]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 4, over four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # the oracle and the deep worlds live in tests/, a namespace package,
    # which a regular package named `tests` anywhere on the path (some
    # installations ship one) would shadow
    tests_pkg = types.ModuleType("tests")
    tests_pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = tests_pkg
    import ocean_bgc  # noqa: F401  (enables x64)
    from ocean_bgc.params import ModelParams
    from ocean_bgc.utils.compile_cache import enable_compile_cache

    ctx = {"card": card(), "params": ModelParams()}
    say(f"phase 0: device")
    say(f"  {ctx['card']}")
    say(f"  jax {jax.__version__}; {len(jax.devices())} x "
        f"{dev.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}; "
        f"compile cache {enable_compile_cache()}")
    phases = ((("phase 4: four cards", phase4),) if args.four_cards else
              (("phase 1: main path", phase1),
               ("phase 2: agreement with the references", phase2),
               ("phase 3: float32 path", phase3)))
    for name, fn in phases:
        say(name)
        t0 = time.perf_counter()
        fn(jax, ctx)
        say(f"  {name.split(':')[0]} ok in {time.perf_counter() - t0:.1f} s "
            f"[{ctx['card']}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
