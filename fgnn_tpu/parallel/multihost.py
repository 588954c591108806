"""Multihost (DCN) support.

The reference is single-machine: its "distribution" is fork + shared
memory (MemoryQueue, pthread process-shared barrier, and a shared-mmap
``ranking_nodes`` that sampler worker 0 fills before trainers init —
dist_engine.cc:115-127, 323-344). Across hosts the same capabilities
map to JAX multi-process primitives:

  fork + shm queue        -> jax.distributed.initialize + global Mesh;
                             batches are globally-sharded arrays, the
                             runtime moves shards between devices
  DistSharedBarrier       -> multihost_utils.sync_global_devices
  shared-mmap ranking     -> process 0 presamples, broadcast_one_to_all
  DistShuffler host shard -> identical epoch-seeded permutation on every
                             host (seed=epoch, dist_shuffler.cc:112-117),
                             each host takes its contiguous step range

Initialization is env-driven so the same app runs single- or multi-host:

  FGNN_TPU_COORDINATOR=host0:port FGNN_TPU_NUM_PROCESSES=N \
  FGNN_TPU_PROCESS_ID=i python examples/train_multihost.py

Each process drives every local GPU by default (one process per host).
``FGNN_TPU_LOCAL_DEVICE_IDS=0`` (comma-separated ids) gives a process only
those cards instead, for one process per card.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils import get_logger

log = get_logger(__name__)


def initialize_from_env() -> bool:
    """jax.distributed.initialize from FGNN_TPU_* env vars. Returns True
    when multihost mode is active. Safe to call more than once."""
    addr = os.environ.get("FGNN_TPU_COORDINATOR")
    if not addr:
        return False
    # NOTE: must run before anything initializes the XLA backend (even
    # jax.devices()), so detect already-initialized via the distributed
    # client state, not a device query
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return True
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(os.environ["FGNN_TPU_NUM_PROCESSES"]),
        process_id=int(os.environ["FGNN_TPU_PROCESS_ID"]),
        local_device_ids=local_device_ids_from_env(),
    )
    log.info("multihost: process %d/%d, %d global / %d local devices",
             jax.process_index(), jax.process_count(),
             len(jax.devices()), len(jax.local_devices()))
    return True


def local_device_ids_from_env() -> Optional[List[int]]:
    """The cards this process drives (FGNN_TPU_LOCAL_DEVICE_IDS), or None
    for all of the host's."""
    ids = os.environ.get("FGNN_TPU_LOCAL_DEVICE_IDS", "").strip()
    return [int(i) for i in ids.split(",")] if ids else None


def global_data_mesh(axis: str = "data") -> Mesh:
    """One mesh over every chip of every host (SGNN/data-parallel)."""
    return Mesh(np.array(jax.devices()), (axis,))


def barrier(name: str = "fgnn") -> None:
    """DistSharedBarrier analog."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def broadcast_from_host0(x: np.ndarray) -> np.ndarray:
    """Shared-mmap ranking analog: host 0's array everywhere (the
    presample-ranking broadcast, dist_engine.cc:115-127)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.broadcast_one_to_all(x))


def host_local_to_global(local: np.ndarray, mesh: Mesh, spec: P):
    """Assemble per-host shards into one global array (the TransData
    hand-off generalized across hosts)."""
    from jax.experimental import multihost_utils

    return multihost_utils.host_local_array_to_global_array(
        local, mesh, spec
    )


def host_step_range(num_step: int, host_id: Optional[int] = None,
                    num_hosts: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous per-host step range (DistShuffler partitioning,
    dist_shuffler.cc:59-79: every worker gets num_step/num_worker steps,
    the last one the remainder)."""
    host_id = jax.process_index() if host_id is None else host_id
    num_hosts = jax.process_count() if num_hosts is None else num_hosts
    per = num_step // num_hosts
    lo = host_id * per
    hi = num_step if host_id == num_hosts - 1 else lo + per
    return lo, hi


def presample_ranking_multihost(sample_fn, shuffler, num_node: int,
                                presample_epoch: int = 1,
                                seed: int = 0) -> np.ndarray:
    """Dist PreSampler analog: process 0 runs the real sampler and ranks
    nodes by access frequency; every other host blocks on the broadcast
    (the reference's barrier + shared mmap, dist_engine.cc:323-344)."""
    if jax.process_index() == 0:
        from ..cache.presample import presample_ranking

        ranking = presample_ranking(
            sample_fn, shuffler, num_node,
            presample_epoch=presample_epoch, seed=seed,
        ).astype(np.int32)
    else:
        ranking = np.zeros(num_node, dtype=np.int32)
    return broadcast_from_host0(ranking)
