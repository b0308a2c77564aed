"""Column-chunked stepping for worlds larger than device memory.

A 0.1-degree global grid is ~6.5M columns; at 60 levels x 35 tracers in
float64 the prognostic state alone is ~100 GB — beyond one device's
memory.  The multi-host answer is the columns mesh (parallel/sharding.py);
the *single-device* answer is this module: keep the world host-resident
(NumPy), stream column chunks through the device, and step each chunk
independently.  Columns never communicate (SURVEY.md §2, parallelism),
so chunking is column-exact: every chunk runs the same compiled program
on its own columns (fixed chunk width; the tail chunk is padded with
land columns, whose tendencies are identically zero by the kmax=0
mask).  Versus an unchunked run the results agree to compile-variant
ulps only — a different batch shape compiles a different executable and
XLA's re-fusion can shift the last bit, exactly as with the level-scan
unroll.

Transfers overlap compute by dispatch pipelining: chunk i+1's
``device_put`` is issued while chunk i computes (JAX's async dispatch),
and results return to pinned host arrays chunk by chunk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax

from ocean_bgc.models.coupled import CoupledState, step
from ocean_bgc.params import ModelParams
from ocean_bgc.state import BGCForcing, ColumnGrid


def _slice_cols(tree, lo: int, width: int, total: int):
    """Take columns [lo, lo+width) of every leaf (columns = last axis),
    zero-padding past ``total`` (pad columns become land: kmax=0)."""

    def take(leaf):
        a = np.asarray(leaf)
        hi = min(lo + width, total)
        part = a[..., lo:hi]
        if hi - lo < width:
            pad = [(0, 0)] * (a.ndim - 1) + [(0, width - (hi - lo))]
            part = np.pad(part, pad)
        return part

    return jax.tree.map(take, tree)


def _write_cols(dst_tree, src_tree, lo: int, total: int):
    """Write device results back into the host arrays (trimming pad)."""

    def put(dst, src):
        a = np.asarray(src)
        hi = min(lo + a.shape[-1], total)
        dst[..., lo:hi] = a[..., :hi - lo]

    jax.tree.map(put, dst_tree, src_tree)


def host_world_like(state: CoupledState, grid: ColumnGrid,
                    forcing: BGCForcing):
    """Deep-copy a world to host NumPy pytrees (the chunked driver's
    resident representation)."""
    to_np = lambda t: jax.tree.map(lambda x: np.array(x), t)  # noqa: E731
    return to_np(state), to_np(grid), to_np(forcing)


def step_chunked(
    host_state: CoupledState,     # NumPy leaves, columns last
    host_grid: ColumnGrid,
    host_forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    *,
    chunk: int = 65536,
    nsteps: int = 1,
    device: Optional[jax.Device] = None,
    carbonate_impl: str = "auto",
) -> CoupledState:
    """Advance a host-resident world ``nsteps`` by streaming column
    chunks through the device.  Returns the updated host state (written
    in place into copies of the input arrays).

    Per-column results are independent of chunk composition (columns
    never communicate; pads are land), matching an unchunked run to
    compile-variant ulps.
    """
    total = np.asarray(host_grid.kmax).shape[-1]
    chunk = min(chunk, total)
    device = device or jax.devices()[0]

    fn = jax.jit(
        lambda s, g, f: _run_steps(s, g, f, params, dt, nsteps,
                                   carbonate_impl),
        donate_argnums=0)

    out_state = jax.tree.map(lambda x: np.array(x), host_state)
    pending = []   # (lo, device result) — drain one behind the head
    for lo in range(0, total, chunk):
        s = jax.device_put(_slice_cols(host_state, lo, chunk, total),
                           device)
        g = jax.device_put(_slice_cols(host_grid, lo, chunk, total),
                           device)
        f = jax.device_put(_slice_cols(host_forcing, lo, chunk, total),
                           device)
        pending.append((lo, fn(s, g, f)))
        if len(pending) > 1:   # keep one chunk in flight
            done_lo, done = pending.pop(0)
            _write_cols(out_state, done, done_lo, total)
    for done_lo, done in pending:
        _write_cols(out_state, done, done_lo, total)
    return out_state


def _run_steps(state, grid, forcing, params, dt, nsteps, carbonate_impl):
    def body(s, _):
        s2, _ = step(s, grid, forcing, params, dt, compute_diags=False,
                     carbonate_impl=carbonate_impl)
        return s2, None

    final, _ = jax.lax.scan(body, state, None, length=nsteps)
    return final
