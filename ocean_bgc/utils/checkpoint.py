"""Checkpoint / resume for the coupled model state.

The reference delegates restart to its host model; the restart payload is
exactly the tracer fields plus the pH warm-start fields (SURVEY.md par.5:
PH_PREV_3D / PH_PREV_ALT_CO2_3D / surface_pH / surface_pH_alt_co2, with
pH == 0 meaning "no previous solution").  Here that payload is one pytree
(:class:`~ocean_bgc.models.coupled.CoupledState`) written with orbax
when available, with a portable NumPy ``.npz`` fallback.

Multi-host safety: the orbax path passes ``jax.Array`` leaves straight
through, so on a pod each process writes only its addressable column
shards (no host gather of non-addressable data — the round-3 bug, where
``np.asarray`` on every leaf forced a full-state gather that raises on a
real multi-process sharded state).  ``restore(path, mesh=...)`` rebuilds
the state already sharded over the given columns mesh, ready to resume
bitwise.  The ``.npz`` path remains single-host only and raises a clear
error if handed non-addressable shards.  Exercised end-to-end (2
processes x 2 devices, save -> restore -> bitwise-identical continue) by
tests/test_distributed_multiprocess.py.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ocean_bgc.models.coupled import CoupledState
from ocean_bgc.state import BGCState

try:  # orbax is optional: without it checkpoints take the .npz route
    import orbax.checkpoint as ocp
    _HAS_ORBAX = True
except ImportError:  # pragma: no cover
    _HAS_ORBAX = False

_FIELDS = (
    "tracers", "ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
    "surface_ph_alt", "dms", "macros",
)


def _flatten(state: CoupledState):
    return {
        "tracers": state.bgc.tracers,
        "ph_prev_3d": state.bgc.ph_prev_3d,
        "ph_prev_alt_3d": state.bgc.ph_prev_alt_3d,
        "surface_ph": state.bgc.surface_ph,
        "surface_ph_alt": state.bgc.surface_ph_alt,
        "dms": state.dms,
        "macros": state.macros,
    }


def _unflatten(d) -> CoupledState:
    return CoupledState(
        bgc=BGCState(
            tracers=jnp.asarray(d["tracers"]),
            ph_prev_3d=jnp.asarray(d["ph_prev_3d"]),
            ph_prev_alt_3d=jnp.asarray(d["ph_prev_alt_3d"]),
            surface_ph=jnp.asarray(d["surface_ph"]),
            surface_ph_alt=jnp.asarray(d["surface_ph_alt"]),
        ),
        dms=jnp.asarray(d["dms"]),
        macros=jnp.asarray(d["macros"]),
    )


def _to_host(x):
    """np.asarray that refuses to silently gather a distributed array.

    A multi-process sharded ``jax.Array`` is not fully addressable from
    any one host; materializing it would either raise deep inside jax or
    force a cross-host gather.  Make the failure mode explicit and point
    at the path that works.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        raise ValueError(
            "state has non-addressable shards (multi-process sharding); "
            "the .npz checkpoint path is single-host only — use the "
            "orbax path (use_orbax=True), which writes each process's "
            "addressable shards")
    return np.asarray(x)


def _col_restore_spec(ndim: int):
    """Columns-on-last-axis PartitionSpec for a rank-``ndim`` leaf (the
    layout invariant of the whole model; parallel/sharding.py::_col_spec).
    Rank-0 leaves (the step counter) replicate."""
    from jax.sharding import PartitionSpec as P

    from ocean_bgc.parallel.sharding import COLUMNS
    if ndim == 0:
        return P()
    return P(*([None] * (ndim - 1) + [COLUMNS]))


def save(path: str, state: CoupledState, *, step: Optional[int] = None,
         use_orbax: Optional[bool] = None) -> str:
    """Write a checkpoint; returns the path written.

    Multi-host: call from EVERY process with the same (globally sharded)
    state — orbax coordinates the write, each process contributing its
    addressable shards.
    """
    if use_orbax is None:
        use_orbax = _HAS_ORBAX
    flat = _flatten(state)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    if use_orbax:
        path = os.path.abspath(path)
        ckptr = ocp.PyTreeCheckpointer()
        # jax.Array leaves pass through unchanged: orbax writes shards
        # per process (multi-host safe); numpy/scalar leaves replicate
        ckptr.save(path, flat, force=True)
        return path
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **jax.tree.map(_to_host, flat))
    return path


def restore(path: str, *, use_orbax: Optional[bool] = None, mesh=None):
    """Read a checkpoint; returns (state, step-or-None).

    ``mesh``: a columns :class:`jax.sharding.Mesh` — the restored leaves
    come back already sharded over it (columns on the last axis,
    replicated elsewhere), with no single-host materialization of the
    global state.  On a pod, call from every process with the global
    mesh.  Requires the orbax path.
    """
    if use_orbax is None:
        use_orbax = _HAS_ORBAX and os.path.isdir(path)
    if mesh is not None and not use_orbax:
        raise ValueError("sharded restore (mesh=...) requires orbax")
    if use_orbax:
        from jax.sharding import NamedSharding
        ckptr = ocp.PyTreeCheckpointer()
        path = os.path.abspath(path)
        if mesh is None:
            flat = ckptr.restore(path)
        else:
            meta = ckptr.metadata(path)
            # orbax >=0.11 wraps the per-leaf ArrayMetadata tree as
            # StepMetadata.item_metadata.tree; fall back level by level
            # (each getattr defaults to ITS OWN input, so a version
            # whose item_metadata is already the raw dict still works)
            inner = getattr(meta, "item_metadata", meta)
            tree_meta = getattr(inner, "tree", inner)
            abstract = {
                k: jax.ShapeDtypeStruct(
                    tuple(m.shape), m.dtype,
                    sharding=NamedSharding(
                        mesh, _col_restore_spec(len(m.shape))))
                for k, m in tree_meta.items()
            }
            flat = ckptr.restore(
                path,
                restore_args=ocp.checkpoint_utils.construct_restore_args(
                    abstract))
    else:
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as f:
            flat = {k: f[k] for k in f.files}
    step = flat.pop("__step__", None)
    state = _unflatten(flat)
    return state, (int(step) if step is not None else None)
