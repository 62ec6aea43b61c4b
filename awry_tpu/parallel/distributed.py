"""Multi-host (multi-process) distribution.

The reference has no cross-process story at all (rayon shared-memory threads
only, src/fm_index.rs:455-487); this module is the framework's host-scale
layer (SURVEY.md section 5, distributed-backend row; section 7 step 7):

* ``init_distributed`` wraps ``jax.distributed.initialize`` so every process
  in a pod slice (or a CPU test rig) joins one JAX runtime and
  ``jax.devices()`` becomes the GLOBAL device list.
* ``make_global_mesh`` builds the ('data', 'shard') mesh DCN-aware: the
  'shard' axis (range-sharded BWT psums, awry_tpu/parallel/sharding.py) is
  laid out WITHIN a host so its collectives ride ICI; the 'data' axis
  (embarrassingly parallel query sharding) spans hosts over DCN, where the
  only traffic is query/result tensors.
* ``process_local_queries`` / ``global_query_batch`` split a global batch
  across processes and assemble the global sharded array each process feeds
  to a shard_map'd engine (jax.make_array_from_process_local_data).

Single-process use degrades gracefully: every helper works unchanged on one
process with N local devices (the CI/test configuration uses the CPU backend
with xla_force_host_platform_device_count virtual devices, SURVEY.md
section 4(d)).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, SHARD_AXIS


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    local_device_ids=None,
) -> None:
    """Join the global JAX runtime (no-op for single-process runs).

    Pass the three arguments explicitly (the coordinator is any free
    ``localhost:<port>`` on one host); only cluster launchers that export
    them let the call omit them.  Safe to
    call twice (second call is ignored)."""
    if num_processes is not None and num_processes <= 1 and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        if "already initialized" in str(e):
            return
        raise


def make_global_mesh(*, shard_size: int = 1, devices=None) -> Mesh:
    """('data', 'shard') mesh over ALL processes' devices, shard axis within
    a host.

    Devices are ordered host-major (sorted by process_index, then local id),
    then reshaped [n // shard_size, shard_size]; with shard_size <= devices
    per host, every 'shard' group is intra-host (ICI), and 'data' parallelism
    spans hosts (DCN).
    """
    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, d.id))
    n = len(devices)
    if n % shard_size != 0:
        raise ValueError(f"{n} devices not divisible by shard_size={shard_size}")
    per_host = max(1, n // max(1, jax.process_count()))
    if shard_size > per_host and jax.process_count() > 1:
        raise ValueError(
            f"shard_size={shard_size} exceeds devices per host ({per_host}); "
            "range-shard collectives would cross DCN"
        )
    arr = np.array(devices).reshape(n // shard_size, shard_size)
    return Mesh(arr, (DATA_AXIS, SHARD_AXIS))


def process_local_queries(queries, mesh: Mesh) -> list:
    """The slice of a replicated global query list this process will encode
    and feed (data-axis sharding maps host-major, matching make_global_mesh)."""
    pc, pi = jax.process_count(), jax.process_index()
    if pc == 1:
        return list(queries)
    per = -(-len(queries) // pc)
    return list(queries[pi * per : (pi + 1) * per])


def global_query_batch(local_qsyms: np.ndarray, local_qlens: np.ndarray, mesh: Mesh):
    """Assemble the GLOBAL data-sharded device arrays from per-process local
    batches (every process must call this collectively)."""
    if jax.process_count() == 1:
        return jax.numpy.asarray(local_qsyms), jax.numpy.asarray(local_qlens)
    qspec = NamedSharding(mesh, P(DATA_AXIS))
    qspec2 = NamedSharding(mesh, P(DATA_AXIS, None))
    qsyms = jax.make_array_from_process_local_data(qspec2, local_qsyms)
    qlens = jax.make_array_from_process_local_data(qspec, local_qlens)
    return qsyms, qlens
