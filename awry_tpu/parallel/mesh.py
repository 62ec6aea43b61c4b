"""Device-mesh helpers.

The reference's only concurrency is a rayon thread pool over queries
(src/fm_index.rs:455-487); scaling here is a jax.sharding Mesh instead:
axis 'data' shards query batches (pure data parallelism), axis 'shard'
range-shards the BWT block arrays for indexes too large for one device's memory
(SURVEY.md section 5, distributed-backend row: Mode A replicate / Mode B
range-shard).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
SHARD_AXIS = "shard"


def make_mesh(num_devices: int | None = None, *, shard_size: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'shard') mesh.

    shard_size devices cooperate on one range-sharded index copy; the
    remaining factor is data parallelism over query batches.  shard_size=1
    gives the pure data-parallel (replicated-index) mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if n % shard_size != 0:
        raise ValueError(f"{n} devices not divisible by shard_size={shard_size}")
    arr = np.array(devices).reshape(n // shard_size, shard_size)
    return Mesh(arr, (DATA_AXIS, SHARD_AXIS))
