"""Mesh role assignment.

The reference dedicates whole GPUs to sampling or training via
process-per-GPU roles (DistEngine::SampleInit/TrainInit,
dist_engine.cc:231-465). Here the devices of one host are split into
a sampler submesh and a trainer submesh; SPMD computations are jitted
over each submesh, and batches move between them as device-to-device
``device_put`` transfers (NVLink between GPUs) — the on-device analog of
FGNN's pinned-shared-memory MemoryQueue. The device lists are flat: every
GPU of a host reaches every other at the same rate, so placement follows
the role split alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class RoleMesh:
    sampler_mesh: Mesh        # axis 'sampler'
    trainer_mesh: Mesh        # axis 'data'
    num_sampler: int
    num_trainer: int

    @property
    def sampler_sharding(self):
        return NamedSharding(self.sampler_mesh, P("sampler"))

    @property
    def sampler_replicated(self):
        return NamedSharding(self.sampler_mesh, P())

    @property
    def trainer_sharding(self):
        return NamedSharding(self.trainer_mesh, P("data"))

    @property
    def trainer_replicated(self):
        return NamedSharding(self.trainer_mesh, P())


def make_role_mesh(
    num_sampler: int,
    num_trainer: int,
    devices: Optional[Sequence] = None,
) -> RoleMesh:
    """Assign the first chips to sampling, the rest to training (the
    reference's device numbering convention, common/__init__.py arch table).
    """
    devices = list(devices if devices is not None else jax.devices())
    assert num_sampler + num_trainer <= len(devices), (
        f"need {num_sampler + num_trainer} devices, have {len(devices)}"
    )
    s_dev = np.array(devices[:num_sampler])
    t_dev = np.array(devices[num_sampler : num_sampler + num_trainer])
    return RoleMesh(
        sampler_mesh=Mesh(s_dev, ("sampler",)),
        trainer_mesh=Mesh(t_dev, ("data",)),
        num_sampler=num_sampler,
        num_trainer=num_trainer,
    )


def make_data_mesh(num_worker: int, devices: Optional[Sequence] = None) -> Mesh:
    """Single-role mesh for SGNN (arch6): every chip samples AND trains."""
    devices = list(devices if devices is not None else jax.devices())
    assert num_worker <= len(devices)
    return Mesh(np.array(devices[:num_worker]), ("data",))
