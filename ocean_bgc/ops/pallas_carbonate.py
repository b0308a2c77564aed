"""Pallas kernel (Triton route) for the float32 dual carbonate solve.

The hottest op of the single-precision step is the dual pH root-find
over every (level, column) cell: two bracketed-Newton solves per cell
(BGC_mod.F90:952-978 -> co2calc.F90:872-997).  The XLA path in
:mod:`ocean_bgc.ops.bgc` runs it as one batch-wide ``while_loop``: on a
GPU every trip re-reads the carry and the cached coefficients from
device memory and returns its predicate to the host.  This kernel
instead gives each block of ``_BLOCK`` cells its own loop: a cell's
whole solve (bracket growth, Newton/bisection iteration, speciation)
stays in registers, a block stops when its own lanes have converged,
and device memory sees one read of the inputs and one write of the
outputs per cell.

With the forcing-invariant coefficient cache (ops/bgc.py::EnvCache) the
kernel reads the 15 precomputed equilibrium constants instead of
evaluating their 11 exponentials, and the (cached) saturation values
drop out of it (``with_sat=False``).

float32 only: the float64 contract path keeps the XLA implementation.
The math is shared: the kernel body calls the same
:mod:`ocean_bgc.ops.carbonate` routines as the XLA path, so only the
scheduling differs.

The kernel compiles for CUDA GPUs.  Elsewhere it runs only when the
caller asks for ``interpret=True`` (the CPU tests); otherwise
``pallas_call`` refuses the backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ocean_bgc.constants import MASS_TO_VOL
from ocean_bgc.ops.carbonate import (
    CarbCoeffs,
    _solve_htotal_impl,
    _to_mass_units,
    carbonate_coeffs,
    co3_sat_vals,
    x0_seed_enabled,
)

# cells per program and warps per program, from a sweep on an H100
# (PERF.md, "Kernel decisions")
_BLOCK = 128
_NUM_WARPS = 2

# benign stand-ins for the pad cells (same trick the XLA path uses for
# below-floor cells): a typical open-ocean cell on which the solver
# converges in a few iterations, so padding never slows a block down
_PAD_VALUES = {
    "depth": 0.0, "temp": 10.0, "salt": 35.0, "press": 0.0,
    "dic": 2000.0, "ta": 2300.0, "pt": 0.5, "sit": 30.0,
    "phlo_a": 6.0, "phhi_a": 9.0, "phlo_b": 6.0, "phhi_b": 9.0,
}
# the (T, S, depth) inputs feed only the coefficients and the
# saturation values, so a kernel that reads cached coefficients and
# skips the saturation values takes only the _SOLVE_ARGS
_ENV_ARGS = ("depth", "temp", "salt", "press")
_SOLVE_ARGS = ("dic", "ta", "pt", "sit", "phlo_a", "phhi_a", "phlo_b",
               "phhi_b")
_N_COEFFS = len(CarbCoeffs._fields)
_LN10 = 2.302585092994045684


def _reads_env(coeffs_in, with_sat):
    return with_sat or not coeffs_in


def _carbonate_kernel(*refs, coeffs_in, with_sat, x0_seed):
    n_env = len(_ENV_ARGS) if _reads_env(coeffs_in, with_sat) else 0
    n_in = n_env + len(_SOLVE_ARGS) + (_N_COEFFS if coeffs_in else 0)
    ins, outs = refs[:n_in], refs[n_in:]
    if n_env:
        depth, temp, salt, press = (r[...] for r in ins[:n_env])
        apply_pressure = press > 0.5
    (dic_ref, ta_ref, pt_ref, sit_ref,
     phlo_a_ref, phhi_a_ref, phlo_b_ref,
     phhi_b_ref) = ins[n_env:n_env + len(_SOLVE_ARGS)]
    if coeffs_in:
        coeffs = CarbCoeffs(*(r[...] for r in
                              ins[n_env + len(_SOLVE_ARGS):]))
    else:
        coeffs = carbonate_coeffs(depth, temp, salt, apply_pressure,
                                  k1_k2_ph_tot=True)
    dic, ta, pt, sit = _to_mass_units(dic_ref[...], ta_ref[...],
                                      pt_ref[...], sit_ref[...])

    def x0_of(phlo, phhi):
        """Previous-root iteration seed, recovered in-kernel: warm
        lanes' brackets are ph_prev +/- DEL_PH, so their pH-space
        midpoint IS ph_prev; cold lanes (the wide init bracket, width
        3) are detected by bracket width and keep the 0 sentinel
        (= start at the H-space bracket midpoint, the reference
        sequence).  See carbonate.py::x0_seed_enabled."""
        warm = (phhi - phlo) < 1.0
        return jnp.where(warm, jnp.exp(-_LN10 * 0.5 * (phlo + phhi)), 0.0)

    def solve_and_speciate(phlo_ref, phhi_ref, out_refs):
        phlo, phhi = phlo_ref[...], phhi_ref[...]
        h = _solve_htotal_impl(
            coeffs, dic, ta, pt, sit,
            jnp.exp(-_LN10 * phhi), jnp.exp(-_LN10 * phlo),
            x0=x0_of(phlo, phhi) if x0_seed else None)
        ph_ref, h2co3_ref, hco3_ref, co3_ref = out_refs
        h2 = h * h
        k12 = coeffs.k1 * coeffs.k2
        denom = 1.0 / (h2 + coeffs.k1 * h + k12)
        ph_ref[...] = -jnp.log10(h)
        h2co3_ref[...] = dic * h2 * denom * MASS_TO_VOL
        hco3_ref[...] = dic * coeffs.k1 * h * denom * MASS_TO_VOL
        co3_ref[...] = dic * k12 * denom * MASS_TO_VOL

    # the two scenarios run one after the other: each loop stops when
    # its own lanes have converged, and the working set stays small
    solve_and_speciate(phlo_a_ref, phhi_a_ref, outs[0:4])
    solve_and_speciate(phlo_b_ref, phhi_b_ref, outs[4:8])
    if with_sat:
        outs[8][...], outs[9][...] = co3_sat_vals(depth, temp, salt,
                                                  apply_pressure)


@functools.partial(jax.jit,
                   static_argnames=("coeffs_in", "with_sat", "x0_seed",
                                    "interpret"))
def _dual_sat_flat(args, *, coeffs_in, with_sat, x0_seed, interpret):
    n = args[0].shape[0]
    spec = pl.BlockSpec((_BLOCK,), lambda i: (i,))
    # under shard_map the outputs vary over the same mesh axes as the
    # inputs; ShapeDtypeStruct must say so or the vma check rejects the
    # pallas_call
    shape = jax.ShapeDtypeStruct((n,), jnp.float32,
                                 vma=jax.typeof(args[0]).vma)
    n_out = 10 if with_sat else 8
    return pl.pallas_call(
        functools.partial(_carbonate_kernel, coeffs_in=coeffs_in,
                          with_sat=with_sat, x0_seed=x0_seed),
        grid=(n // _BLOCK,),
        in_specs=[spec] * len(args),
        out_specs=(spec,) * n_out,
        out_shape=(shape,) * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="carbonate_dual_f32",
    )(*args)


def co3_terms_dual_sat_pallas(depth_m, temp, salt, dic, ta, pt, sit,
                              phlo_a, phhi_a, phlo_b, phhi_b,
                              apply_pressure, *,
                              coeffs: CarbCoeffs = None,
                              with_sat: bool = True,
                              interpret: bool = False):
    """Fused fp32 dual carbonate solve (+ saturation values), one Pallas
    kernel over all cells.

    Drop-in for the hoisted block in ``bgc_source_sink``: semantically
    ``co3_terms_dual(...) + co3_sat_vals(...)`` (comp_CO3terms,
    co2calc.F90:214-316 twice + comp_co3_sat_vals, co2calc.F90:1096-1238),
    evaluated in float32.

    Inputs may be any (broadcastable-to-common) shape; outputs match the
    broadcast shape.  ``apply_pressure`` is the per-cell subsurface gate.

    ``coeffs``: precomputed equilibrium constants (the forcing-invariant
    cache) — the kernel reads them instead of evaluating their 11
    exponentials per cell.  ``with_sat=False`` skips the saturation
    values (they are forcing-invariant too; cached callers already have
    them) and returns ``None`` in their slot.

    ``interpret``: run the kernel in the Pallas interpreter (CPU tests).
    Without it the kernel compiles for the GPU, and ``pallas_call``
    raises on any other backend.

    Returns ``((ph_a, h2co3_a, hco3_a, co3_a),
               (ph_b, h2co3_b, hco3_b, co3_b),
               (co3_sat_calc, co3_sat_arag) | None)``.
    """
    named = dict(depth=depth_m, temp=temp, salt=salt,
                 press=jnp.asarray(apply_pressure, jnp.float32),
                 dic=dic, ta=ta, pt=pt, sit=sit, phlo_a=phlo_a,
                 phhi_a=phhi_a, phlo_b=phlo_b, phhi_b=phhi_b)
    shape = jnp.broadcast_shapes(*(jnp.shape(v) for v in named.values()))
    n = 1
    for s in shape:
        n *= s
    n_pad = -(-max(n, 1) // _BLOCK) * _BLOCK

    def flatten(v, pad_value=None):
        v = jnp.broadcast_to(jnp.asarray(v, jnp.float32),
                             shape).reshape(-1)
        if n_pad == n:
            return v
        if pad_value is None:
            # edge padding: pad lanes replicate the last real cell, so
            # the solver converges on them like any other
            return jnp.pad(v, (0, n_pad - n), mode="edge")
        return jnp.pad(v, (0, n_pad - n), constant_values=pad_value)

    coeffs_in = coeffs is not None
    names = ((_ENV_ARGS if _reads_env(coeffs_in, with_sat) else ())
             + _SOLVE_ARGS)
    flat = [flatten(named[k], _PAD_VALUES[k]) for k in names]
    if coeffs_in:
        flat.extend(flatten(v) for v in coeffs)

    outs = _dual_sat_flat(tuple(flat), coeffs_in=coeffs_in,
                          with_sat=with_sat, x0_seed=x0_seed_enabled(),
                          interpret=interpret)
    outs = [o[:n].reshape(shape) for o in outs]
    sat = tuple(outs[8:10]) if with_sat else None
    return tuple(outs[0:4]), tuple(outs[4:8]), sat
