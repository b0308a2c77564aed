"""Multi-process initialization and data placement.

The reference's host model distributes columns across MPI ranks; here
that is ``jax.distributed`` + a global columns mesh over every device of
every process.  Because columns never communicate, each host feeds only
its own shard (``host_local_columns``), and the one collective per step
is the diagnostics psum.

Typical multi-process usage::

    from ocean_bgc.parallel import distributed as dist
    dist.initialize()                    # once per process, before jax use
    mesh = dist.global_mesh()
    lo, hi = dist.host_local_columns(total_columns, mesh)
    # build/load this host's columns [lo:hi), then:
    state = dist.host_local_to_global(local_state, mesh, total_columns)

This module is exercised in single-process form by the test suite and the
virtual-device dry run, and over 2 CPU processes by
tests/test_distributed_multiprocess.py; a real multi-host run takes the
identical code path (jax.distributed only changes who owns which mesh
devices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ocean_bgc.parallel.sharding import COLUMNS, _col_spec


def _cluster_env_present() -> bool:
    """Whether JAX's own cluster autodetection (the launchers
    ``jax.distributed.initialize()`` reads without arguments: SLURM,
    Open MPI, Kubernetes, ...) finds one."""
    from jax._src.clusters import ClusterEnv
    return any(env.is_env_present() for env in ClusterEnv._cluster_types
               if not env.opt_in_only_method)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` for a multi-process run.

    With no arguments and no cluster environment the run is a single
    process, and this is a no-op.  Otherwise the arguments (or the
    cluster environment) go to ``jax.distributed.initialize``, and any
    failure there propagates."""
    if (coordinator_address is None and num_processes is None
            and process_id is None and not _cluster_env_present()):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def global_mesh() -> Mesh:
    """1-D columns mesh over every device in the (possibly multi-host)
    runtime."""
    return Mesh(np.array(jax.devices()), (COLUMNS,))


def host_local_columns(total_columns: int, mesh: Mesh) -> Tuple[int, int]:
    """The [lo, hi) slice of the global column axis this process owns
    (columns are block-distributed in device order)."""
    devs = list(mesh.devices.flat)
    n = len(devs)
    per = total_columns // n
    assert per * n == total_columns, (
        f"total_columns={total_columns} must divide the {n}-device mesh")
    mine = [i for i, d in enumerate(devs)
            if d.process_index == jax.process_index()]
    if not mine:
        return 0, 0
    return mine[0] * per, (mine[-1] + 1) * per


def host_local_to_global(local_tree, mesh: Mesh, total_columns: int):
    """Assemble a global sharded pytree from each host's local column
    block (jax.make_array_from_process_local_data under the hood)."""

    def assemble(x):
        global_shape = x.shape[:-1] + (total_columns,)
        sharding = NamedSharding(mesh, _col_spec(x))
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x), global_shape)

    return jax.tree.map(assemble, local_tree)
