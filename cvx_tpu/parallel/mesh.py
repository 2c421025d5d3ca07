"""Device mesh helpers.

The reference has no distribution at all (SURVEY.md section 2.4); this is the
framework's communication layer, built entirely on jax.sharding + XLA
collectives (NCCL on GPUs) — no hand-written transport (SURVEY.md section 5.8).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize jax.distributed for multi-host clusters.

    Pass the coordinator address, process count and process id: nothing
    discovers a GPU cluster from the environment.  Returns the process
    count.  Meshes built afterwards with instance_mesh()/block_mesh() span
    ALL hosts' devices and shard_map collectives cross hosts — per SURVEY.md
    section 5.8 there is no custom transport to write.
    """
    import jax

    if coordinator is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_count()


def instance_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over devices for instance-batch (data) parallelism."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def block_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    """1-D mesh for block-separable Schur-consensus problems."""
    return instance_mesh(n_devices, axis)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    def put(leaf):
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, x)
