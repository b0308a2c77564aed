"""Time-averaged history output — the host model's "tavg" layer.

The reference registers its diagnostics for the host's time-averaged
history files (the tavg comments in BGC_mod.F90:1794 "various tavg/history
variables"); the host does the averaging and IO.  This module supplies
that layer: a jit-compatible running accumulator over selected diagnostics
plus a portable .npz writer with the registry metadata attached.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ocean_bgc.utils.diag import coupled_registry


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TavgState:
    """Running sums of selected diagnostics + the sample count."""

    sums: Dict[str, jax.Array]
    count: jax.Array     # scalar int32

    @staticmethod
    def create(template: Dict[str, jax.Array],
               fields: Optional[Sequence[str]] = None) -> "TavgState":
        names = list(fields) if fields is not None else list(template)
        missing = set(names) - set(template)
        if missing:
            raise KeyError(f"unknown diagnostics: {sorted(missing)}")
        return TavgState(
            sums={n: jnp.zeros_like(template[n]) for n in names},
            count=jnp.zeros((), jnp.int32))

    def accumulate(self, diags: Dict[str, jax.Array]) -> "TavgState":
        return TavgState(
            sums={n: s + diags[n] for n, s in self.sums.items()},
            count=self.count + 1)

    def means(self) -> Dict[str, jax.Array]:
        c = jnp.maximum(self.count, 1).astype(
            next(iter(self.sums.values())).dtype if self.sums else
            jnp.float64)
        return {n: s / c for n, s in self.sums.items()}

    def reset(self) -> "TavgState":
        return TavgState(
            sums={n: jnp.zeros_like(s) for n, s in self.sums.items()},
            count=jnp.zeros((), jnp.int32))


def write_history(path: str, tavg: TavgState, *,
                  attrs: Optional[Dict[str, str]] = None) -> str:
    """Write the current means to ``path`` (.npz) with units/long-name
    metadata from the diagnostics registry."""
    registry = coupled_registry()
    means = {n: np.asarray(v) for n, v in tavg.means().items()}
    meta = {}
    for n in means:
        spec = registry.get(n)
        if spec is not None:
            meta[f"__units__{n}"] = np.str_(spec.units)
            meta[f"__desc__{n}"] = np.str_(spec.description)
    if attrs:
        meta.update({f"__attr__{k}": np.str_(v) for k, v in attrs.items()})
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, __count__=np.asarray(tavg.count), **means, **meta)
    return path


def write_history_shards(dirpath: str, fields: Dict[str, jax.Array], *,
                         process_index: Optional[int] = None,
                         tag: str = "hist") -> str:
    """The pod history writer: each process writes ONLY its addressable
    column shards, with their global offsets, to a per-process file —
    no gather, no collective (the consumer the
    ``make_sharded_step(local_diags=...)`` path produces its sharded
    fields for; parallel/sharding.py).  Replicated leaves (scalars such
    as the psum'd health counters, or fully-replicated arrays) are
    written by process 0 only.

    Layout: ``<dirpath>/<tag>_p<process>.npz`` holding
    ``<name>@<col0>`` blocks plus a ``__shape__<name>`` global-shape
    entry per field; :func:`stitch_history_shards` reassembles the
    global arrays (bitwise: the blocks are exact copies of the device
    shards).  Returns the written path.
    """
    import os

    os.makedirs(dirpath, exist_ok=True)
    pid = (process_index if process_index is not None
           else jax.process_index())
    out: Dict[str, np.ndarray] = {}
    for name, arr in fields.items():
        if "@" in name or name.startswith("__"):
            raise ValueError(f"field name {name!r} collides with the "
                             "shard-file key syntax")
        if not isinstance(arr, jax.Array):
            arr = jnp.asarray(arr)
        out[f"__shape__{name}"] = np.asarray(arr.shape, np.int64)
        if arr.ndim == 0 or arr.is_fully_replicated:
            if pid == 0:
                out[f"{name}@r"] = np.asarray(arr)
            continue
        seen = set()
        for shard in arr.addressable_shards:
            col0 = shard.index[-1].start or 0
            if col0 in seen:       # replication over non-column axes
                continue
            seen.add(col0)
            out[f"{name}@{col0}"] = np.asarray(shard.data)
    path = os.path.join(dirpath, f"{tag}_p{pid}.npz")
    np.savez(path, **out)
    return path


def stitch_history_shards(dirpath: str, *, tag: str = "hist"
                          ) -> Dict[str, np.ndarray]:
    """Reassemble the global history arrays from every process's shard
    file (``write_history_shards``).  Offsets are concatenated along
    the trailing (columns) axis; full coverage is verified against the
    recorded global shapes; overlapping blocks (replication) must be
    bitwise identical.  Bitwise-exact: no arithmetic touches the data.
    """
    import glob
    import os

    parts = sorted(glob.glob(os.path.join(dirpath, f"{tag}_p*.npz")))
    if not parts:
        raise FileNotFoundError(
            f"no {tag}_p*.npz shard files under {dirpath}")
    shapes: Dict[str, tuple] = {}
    blocks: Dict[str, Dict[int, np.ndarray]] = {}
    replicated: Dict[str, np.ndarray] = {}
    for p in parts:
        with np.load(p) as f:
            for key in f.files:
                if key.startswith("__shape__"):
                    shapes[key[len("__shape__"):]] = tuple(
                        int(x) for x in f[key])
                    continue
                name, off = key.rsplit("@", 1)
                if off == "r":
                    replicated[name] = f[key]
                    continue
                prev = blocks.setdefault(name, {}).get(int(off))
                if prev is not None:
                    if not np.array_equal(prev, f[key]):
                        raise ValueError(
                            f"overlapping shards of {name!r} at column "
                            f"{off} disagree across processes")
                else:
                    blocks[name][int(off)] = f[key]
    out: Dict[str, np.ndarray] = {}
    for name, shape in shapes.items():
        if name in replicated:
            out[name] = replicated[name]
            continue
        offs = sorted(blocks.get(name, {}))
        got = 0
        for o in offs:
            if o != got:
                raise ValueError(
                    f"missing shard of {name!r}: gap at column {got}")
            got = o + blocks[name][o].shape[-1]
        if got != shape[-1]:
            raise ValueError(
                f"missing trailing shards of {name!r}: have {got} of "
                f"{shape[-1]} columns")
        out[name] = np.concatenate([blocks[name][o] for o in offs],
                                   axis=-1)
        if out[name].shape != shape:
            raise ValueError(
                f"stitched shape {out[name].shape} != recorded "
                f"{shape} for {name!r}")
    return out


def read_history(path: str):
    """Returns (means dict, count, metadata dict)."""
    with np.load(path) as f:
        count = int(f["__count__"])
        means, meta = {}, {}
        for k in f.files:
            if k == "__count__":
                continue
            if k.startswith("__"):
                meta[k] = str(f[k])
            else:
                means[k] = f[k]
    return means, count, meta
