"""Multi-host orchestration: jax.distributed init + host-local IO helpers.

Single-host multi-card needs nothing special — `make_mesh()` spans all local
devices.  Across processes or hosts, every process must:

  1. call `initialize()` with the coordinator's address (`host:port`), the
     process count and its own id — nothing on a plain GPU machine tells
     JAX about a cluster,
  2. build the SAME global mesh from `jax.devices()` (all processes see the
     global device list),
  3. feed sharded inputs via `host_local_target()` (each host materializes
     only its row bands), and
  4. fetch outputs with `fetch_rows()` (only this host's shards transfer).

The sharded render/grad steps (sharded.py, diffshard.py) are already
expressed with shard_map over named axes, so XLA places the psum/all-gather
collectives itself (NCCL on the GPU) — there is no separate
"communication backend" to configure (the reference has no multi-device
capability at all; SURVEY.md §2).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import make_mesh  # noqa: F401  (re-export for convenience)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with pass-through args; no-op if already
    initialized (safe to call unconditionally at program start)."""
    if getattr(jax.distributed, "is_initialized", None) and jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # jax raises "distributed.initialize should only be called once." on
        # re-init (jax 0.9 _src/distributed.py); older versions said
        # "already initialized"
        msg = str(e).lower()
        if "already" not in msg and "only be called once" not in msg:
            raise


def is_multihost() -> bool:
    return jax.process_count() > 1


def replicate(mesh, tree):
    """Replicate a host-value pytree across the global mesh.

    Every process passes identical values (e.g. the compiled scene / render
    params built from the same code); returns globally-replicated jax.Arrays
    usable as inputs to the sharded step on a multi-process mesh.  Plain
    `device_put` refuses process-local values against a global sharding, so
    this goes through `make_array_from_callback` (verified bit-identical to
    the single-process render in tests/test_parallel.py's 2-process test).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())

    def _one(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    return jax.tree.map(_one, tree)


def host_local_target(mesh, target: np.ndarray, sharding) -> jax.Array:
    """Build a globally-sharded (H, W, 3) array from per-host numpy data.

    Each process passes the FULL-size numpy target; only the rows owned by
    this host's devices are uploaded (make_array_from_callback slices
    host-side).  On a single host this is just device_put with the sharding.
    """
    target = np.asarray(target)

    def cb(index):
        return target[index]

    return jax.make_array_from_callback(target.shape, sharding, cb)


def fetch_rows(arr: jax.Array) -> tuple[np.ndarray, np.ndarray]:
    """Gather this host's shards of a row-sharded array.

    Returns (rows_present (bool mask over H), data (H, W, 3) with rows this
    host does not own zeroed).  Callers on a driver host typically combine
    via jax.experimental.multihost_utils or write per-host tiles to disk.
    """
    H = arr.shape[0]
    data = np.zeros(arr.shape, arr.dtype)
    present = np.zeros((H,), bool)
    for shard in arr.addressable_shards:
        sl = shard.index[0]
        data[sl] = np.asarray(shard.data)
        present[sl] = True
    return present, data
