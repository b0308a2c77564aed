"""Differentiable trajectories: exact adjoints and variational calibration.

The reference is a Fortran tendency library with NO adjoint — parameter
sensitivity there means finite-difference re-runs of the whole model, and
variational data assimilation would require a hand-maintained tangent/
adjoint code (none exists for BGC_mod.F90; its parameters are set once by
``BGC_parms_init``, BGC_parms.F90:497-699, and tuned by hand).  Because
every kernel in this framework is a pure JAX function, reverse-mode AD
yields the EXACT adjoint of the entire coupled integration for free:
``jax.grad`` flows through the air-sea fluxes, all three source-sink
kernels, the carbonate root-find (implicit-function-theorem custom VJP,
ops/carbonate.py), and the time-stepping scan.

Two backward-pass memory regimes:

- ``remat=True`` (default): each step is wrapped in ``jax.checkpoint``, so
  the backward pass stores only the per-step state carries and recomputes
  the step interiors — a 1000-step adjoint holds ~1000 small states, not
  the full intermediate tape.
- ``remat=False``: XLA keeps every intermediate (fastest for short
  horizons that fit in memory).

The params layer is deliberately static (hashable dataclasses whose floats
fold into the compiled kernel — params.py docstring).  For calibration,
:func:`override_params` rebuilds a ``ModelParams`` with selected NUMERIC
fields replaced by traced values; the kernels retrace with those leaves as
differentiable inputs.  Structural fields (bools, ``temp_function``,
``grazee_ind``) steer trace-time code paths and cannot carry tracers —
:func:`override_params` rejects them.

Paths are dotted field names with optional tuple indexing, e.g.
``"bgc.parm_kappa_nitrif"``, ``"bgc.autotrophs[0].PCref"``,
``"dms.k_conv"``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import CoupledState, step
from ocean_bgc.ops.bgc import precompute_env
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCForcing, ColumnGrid

_INDEXED = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)\[(\d+)\]$")

# Fields that steer trace-time (static) code paths; a traced override of
# one of these could not change the compiled program and would silently
# mis-calibrate, so they are rejected up front.
_STRUCTURAL_FIELDS = frozenset({
    "temp_function", "grazee_ind", "has_si", "nfixer", "imp_calcifier",
    "exp_calcifier", "sname", "lname",
})


def get_param(params: Any, path: str):
    """Read the value at a dotted/indexed parameter ``path``."""
    obj = params
    for part in path.split("."):
        m = _INDEXED.match(part)
        if m:
            obj = getattr(obj, m.group(1))[int(m.group(2))]
        else:
            obj = getattr(obj, part)
    return obj


def _set(obj: Any, parts: Sequence[str], value: Any):
    part, rest = parts[0], parts[1:]
    m = _INDEXED.match(part)
    if m:
        name, idx = m.group(1), int(m.group(2))
        seq = getattr(obj, name)
        elem = _set(seq[idx], rest, value) if rest else value
        new_seq = tuple(elem if i == idx else e for i, e in enumerate(seq))
        return dataclasses.replace(obj, **{name: new_seq})
    if rest:
        return dataclasses.replace(
            obj, **{part: _set(getattr(obj, part), rest, value)})
    if part in _STRUCTURAL_FIELDS or isinstance(getattr(obj, part), bool):
        raise TypeError(
            f"{part!r} is a structural (trace-time) field; it selects "
            "compiled code paths and cannot be overridden with a traced "
            "value")
    return dataclasses.replace(obj, **{part: value})


def override_params(params: ModelParams,
                    overrides: Mapping[str, Any]) -> ModelParams:
    """Rebuild ``params`` with the numeric fields named by ``overrides``
    replaced — values may be Python floats (new static configuration) or
    JAX tracers/arrays (differentiable calibration inputs)."""
    out = params
    for path, value in overrides.items():
        out = _set(out, path.split("."), value)
    return out


def run_diff(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    *,
    remat: bool = True,
    env_cache: bool = True,
    carbonate_impl: str = "auto",
    obs_fn: Optional[Callable[[CoupledState], Any]] = None,
):
    """Integrate ``nsteps`` (diags off) as one reverse-differentiable scan.

    Functionally the production ``run(...)`` path (constant forcing,
    hoisted env cache), restructured for the adjoint: the step is
    optionally rematerialized, and ``obs_fn(state)`` — an arbitrary pytree
    observation operator — is evaluated on the post-step state each step
    and stacked along a leading time axis (the "H(x)" of variational
    assimilation).

    Returns ``final_state``, or ``(final_state, observations)`` when
    ``obs_fn`` is given.  ``params`` may carry traced leaves from
    :func:`override_params`; the env cache is computed from them inside
    the trace, so gradients flow through it.
    """
    env = precompute_env(grid, forcing, params.bgc) if env_cache else None

    def one_step(s: CoupledState) -> CoupledState:
        s2, _ = step(s, grid, forcing, params, dt, compute_diags=False,
                     carbonate_impl=carbonate_impl, env=env)
        return s2

    if remat:
        one_step = jax.checkpoint(one_step)

    def body(s, _):
        s2 = one_step(s)
        return s2, (obs_fn(s2) if obs_fn is not None else None)

    final, obs = jax.lax.scan(body, state, None, length=nsteps)
    if obs_fn is not None:
        return final, obs
    return final


def _default_loss(sim, observed):
    """Scale-free mean-squared misfit, averaged over pytree leaves (each
    leaf normalized by its observed magnitude so multi-field observations
    with different units weigh comparably)."""
    def leaf(a, b):
        scale = jnp.mean(jnp.abs(b)) + 1e-30
        return jnp.mean(((a - b) / scale) ** 2)

    leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(leaf, sim, observed))
    return sum(leaves) / len(leaves)


def parameter_sensitivities(
    template: ModelParams,
    paths: Sequence[str],
    state0: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    dt: float,
    nsteps: int,
    functional: Callable[[CoupledState], jax.Array],
    *,
    relative: bool = True,
    remat: bool = True,
    env_cache: bool = True,
) -> Dict[str, float]:
    """All parameter sensitivities of a scalar trajectory functional in
    ONE reverse sweep.

    ``functional(final_state) -> scalar`` is the quantity of interest
    (e.g. integrated surface CO2 flux, total NPP).  Returns
    ``{path: dJ/d ln p}`` by default (``relative=True`` — the
    scale-free "1% parameter change moves J by this much / 100" form a
    tuning study wants), or raw ``dJ/dp`` with ``relative=False``.

    The cost is ONE forward + ONE backward integration regardless of
    ``len(paths)`` — the adjoint advantage over the reference's only
    option, a finite-difference re-run per parameter.
    """
    paths = tuple(paths)
    base = np.asarray([float(get_param(template, p)) for p in paths])
    if relative and not (base != 0).all():
        raise ValueError("relative=True requires nonzero base values")

    def objective(theta):
        vals = [base[i] * theta[i] if relative else theta[i]
                for i in range(len(paths))]
        params = override_params(template, dict(zip(paths, vals)))
        final = run_diff(state0, grid, forcing, params, dt, nsteps,
                         remat=remat, env_cache=env_cache)
        return functional(final)

    theta0 = (jnp.ones(len(paths), dtype=jnp.float64) if relative
              else jnp.asarray(base))
    g = jax.jit(jax.grad(objective))(theta0)
    return {p: float(g[i]) for i, p in enumerate(paths)}


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`calibrate`."""

    params: ModelParams            # template with the fitted values
    values: Dict[str, float]       # fitted value per path
    losses: List[float]            # losses[0] = initial; losses[-1] = at
                                   # the RETURNED params (iters+1 entries)
    theta: np.ndarray              # raw optimizer variables at exit


def calibrate(
    template: ModelParams,
    paths: Sequence[str],
    state0: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    dt: float,
    nsteps: int,
    observations: Any,
    obs_fn: Callable[[CoupledState], Any],
    *,
    init: Optional[Mapping[str, float]] = None,
    iters: int = 100,
    learning_rate: float = 0.05,
    transform: str = "log",
    optimizer=None,
    loss_fn: Optional[Callable[[Any, Any], jax.Array]] = None,
    remat: bool = True,
    env_cache: bool = True,
) -> CalibrationResult:
    """Variational parameter estimation against observed trajectories.

    Fits the parameters named by ``paths`` so that the model trajectory's
    ``obs_fn`` outputs match ``observations`` (a pytree stacked along a
    leading time axis, exactly what :func:`run_diff` returns) — gradient
    descent through the full adjoint of the coupled model, the capability
    the Fortran reference fundamentally lacks (its parameters are
    hand-tuned constants, BGC_parms.F90:346-365).

    ``transform="log"`` (default) optimizes positive rates in log space
    (value = init * exp(theta)) — sign-safe and naturally relative;
    ``"linear"`` optimizes the raw value.  ``init`` defaults to the
    template's current values (the first-guess state of the namelist).
    ``optimizer`` is any optax GradientTransformation (default
    ``optax.adam(learning_rate)``).
    """
    import optax

    if transform not in ("log", "linear"):
        raise ValueError(f"unknown transform {transform!r}")
    paths = tuple(paths)
    init_vals = np.asarray(
        [float((init or {}).get(p, get_param(template, p))) for p in paths])
    if transform == "log" and not (init_vals > 0).all():
        raise ValueError("transform='log' requires positive initial values")
    loss_fn = loss_fn or _default_loss

    def to_values(theta):
        if transform == "log":
            return [init_vals[i] * jnp.exp(theta[i])
                    for i in range(len(paths))]
        return [init_vals[i] + theta[i] for i in range(len(paths))]

    def objective(theta):
        params = override_params(
            template, dict(zip(paths, to_values(theta))))
        _, sim = run_diff(state0, grid, forcing, params, dt, nsteps,
                          remat=remat, env_cache=env_cache, obs_fn=obs_fn)
        return loss_fn(sim, observations)

    value_and_grad = jax.jit(jax.value_and_grad(objective))
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    theta = jnp.zeros(len(paths), dtype=jnp.float64)
    opt_state = opt.init(theta)
    losses: List[float] = []
    for _ in range(iters):
        loss, g = value_and_grad(theta)
        losses.append(float(loss))
        updates, opt_state = opt.update(g, opt_state, theta)
        theta = optax.apply_updates(theta, updates)
    # one final evaluation so losses[-1] is the loss AT the returned
    # parameters (the loop records the loss before each update, which
    # would misreport final fit quality by one optimizer step)
    if iters > 0:
        losses.append(float(value_and_grad(theta)[0]))

    values = {p: float(v) for p, v in zip(paths, to_values(theta))}
    return CalibrationResult(
        params=override_params(template, values),
        values=values,
        losses=losses,
        theta=np.asarray(theta),
    )
