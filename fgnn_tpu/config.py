"""Run configuration.

Analog of the reference's all-static ``RunConfig``
(samgraph/common/run_config.{h,cc}) and the builtin arch table
(samgraph/common/__init__.py:97-132). Instead of a
mutable global we use a frozen dataclass passed explicitly; enums mirror the
reference's (common.h:38-92) so configs translate one-to-one.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence, Tuple

from . import constants


class SampleType(enum.Enum):
    """Mirror of SampleType (common.h:58-68)."""

    KHOP0 = "khop0"                  # reservoir: uniform w/o replacement
    KHOP1 = "khop1"                  # uniform with replacement
    KHOP2 = "khop2"                  # Fisher-Yates w/o replacement (default GCN)
    WEIGHTED_KHOP = "weighted_khop"  # alias-table weighted
    RANDOM_WALK = "random_walk"      # PinSAGE walks + top-k by visit count
    WEIGHTED_KHOP_PREFIX = "weighted_khop_prefix"
    WEIGHTED_KHOP_HASH_DEDUP = "weighted_khop_hash_dedup"

    @property
    def is_khop(self) -> bool:
        return self in (
            SampleType.KHOP0,
            SampleType.KHOP1,
            SampleType.KHOP2,
            SampleType.WEIGHTED_KHOP,
            SampleType.WEIGHTED_KHOP_PREFIX,
            SampleType.WEIGHTED_KHOP_HASH_DEDUP,
        )


# default sampler of each model family, shared by the training app
# (examples/train_gnn.py) and the exp/ runners
MODEL_SAMPLE_TYPE = {
    "gcn": "khop2",
    "graphsage": "khop0",
    "pinsage": "random_walk",
    "gat": "khop2",
}


class CachePolicy(enum.Enum):
    """Mirror of CachePolicy (common.h:70-80)."""

    DEGREE = "degree"
    HEURISTIC = "heuristic"
    PRESAMPLE = "pre_sample"
    DEGREE_HOP = "degree_hop"
    PRESAMPLE_STATIC = "presample_static"
    FAKE_OPTIMAL = "fake_optimal"
    DYNAMIC_CACHE = "dynamic_cache"
    RANDOM = "random"


class RunArch(enum.Enum):
    """Mirror of RunArch arch0-7 (common.h:47-56, __init__.py:97-132).

    The reference's per-GPU process roles become device/mesh roles inside
    one process:
      ARCH0: host (CPU) sampling + device training.
      ARCH1: sample + extract + train all on one device.
      ARCH2/3: sampler device + trainer device, host-mediated extraction.
      ARCH5: FGNN factored — dedicated sampler devices + trainer devices
             with an on-device task queue (the flagship).
      ARCH6: SGNN — every device samples AND trains (space-shared
             baseline).
    """

    ARCH0 = 0
    ARCH1 = 1
    ARCH2 = 2
    ARCH3 = 3
    ARCH4 = 4
    ARCH5 = 5
    ARCH6 = 6
    ARCH7 = 7


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Frozen run configuration (run_config.h:24-99 analog)."""

    # dataset
    dataset: str = "products"
    dataset_root: str = constants.DEFAULT_DATASET_ROOT

    # architecture / roles
    arch: RunArch = RunArch.ARCH5
    num_sample_worker: int = 1
    num_train_worker: int = 1

    # sampling
    sample_type: SampleType = SampleType.KHOP2
    fanout: Tuple[int, ...] = (25, 10)   # deepest-first like the reference
    batch_size: int = 8000
    num_epoch: int = 10

    # random walk (PinSAGE) parameters (run_config.h:52-57)
    random_walk_length: int = 3
    random_walk_restart_prob: float = 0.5
    num_random_walk: int = 4
    num_neighbor: int = 5
    num_layer_rw: int = 3

    # cache
    cache_policy: CachePolicy = CachePolicy.PRESAMPLE
    cache_percentage: float = 0.0
    presample_epoch: int = 1

    # model / training
    model: str = "graphsage"
    num_hidden: int = 256
    lr: float = 0.003
    dropout: float = 0.5
    weight_decay: float = 0.0

    # pipeline
    pipeline: bool = True
    max_sampling_jobs: int = 10
    max_copying_jobs: int = 10

    # balance switcher (arch5 + switcher role, balance_switcher apps):
    # idle sampler chips join training for the tail of each epoch
    have_switcher: bool = False
    switch_cache_percentage: float = 0.0

    # async data-parallel training (async/train_graphsage.py analog):
    # trainers step local replicas, averaging every `async_sync_every` steps
    async_train: bool = False
    async_sync_every: int = 1

    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # checkpoint/resume (idiomatic upgrade — the reference has none,
    # SURVEY.md §5.4; NumPy archives, train/checkpoint.py)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0          # save every N epochs; 0 = off

    # misc / observability
    barriered_epoch: int = 0
    profile_level: int = 1
    sanity_check: bool = False
    empty_feat: int = 0          # log2 of fake feature-table size; 0 = off
    seed: int = 0

    @property
    def num_layer(self) -> int:
        if self.sample_type == SampleType.RANDOM_WALK:
            return self.num_layer_rw
        return len(self.fanout)

    @property
    def num_fanout(self) -> int:
        return len(self.fanout)

    @property
    def use_cache(self) -> bool:
        return self.cache_percentage > 0.0

    def validate(self) -> "RunConfig":
        """CHECK-style invariants (operation.cc:58-121 analog)."""
        assert self.batch_size > 0
        assert 0.0 <= self.cache_percentage <= 1.0
        assert self.num_epoch > 0
        if self.sample_type == SampleType.RANDOM_WALK:
            assert self.num_random_walk > 0 and self.random_walk_length > 0
            assert self.num_neighbor > 0
        else:
            assert len(self.fanout) > 0 and all(f > 0 for f in self.fanout)
        if self.arch in (RunArch.ARCH5, RunArch.ARCH6):
            assert self.num_sample_worker >= 1
            assert self.num_train_worker >= 1
        return self

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_dict(d: dict) -> "RunConfig":
        """Parse a loosely-typed k/v config (samgraph_config analog,
        operation.cc:45-169). Unknown keys raise."""
        kw = {}
        fields = {f.name: f for f in dataclasses.fields(RunConfig)}
        for k, v in d.items():
            if k not in fields:
                raise KeyError(f"unknown config key: {k}")
            f = fields[k]
            if f.name == "arch":
                if isinstance(v, str) and v.lower().startswith("arch"):
                    v = v[4:]           # "arch5" → 5 (builtin arch table names)
                v = RunArch(int(v)) if not isinstance(v, RunArch) else v
            elif f.name == "sample_type":
                v = SampleType(v) if not isinstance(v, SampleType) else v
            elif f.name == "cache_policy":
                v = CachePolicy(v) if not isinstance(v, CachePolicy) else v
            elif f.name == "fanout" and not isinstance(v, tuple):
                v = tuple(int(x) for x in v)
            kw[k] = v
        return RunConfig(**kw).validate()


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("", "0", "false", "False", "off")


def env_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)
