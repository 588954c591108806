"""Train-set shufflers.

Analogs of GPUShuffler (cuda_shuffler.cc), DistShuffler (dist_shuffler.cc)
and DistAlignedShuffler (dist_shuffler_aligned.cc). Shuffling happens
host-side (tiny arrays); the epoch permutation is seeded by epoch number so
every sampler worker derives the *same* global order and takes its own
contiguous step range — exactly the reference's reproducible partitioning
(dist_shuffler.cc:112-117, :59-79).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


def _num_step(n: int, batch_size: int) -> int:
    return (n + batch_size - 1) // batch_size


class EpochShuffler:
    """Single-worker epoch shuffler (GPUShuffler analog)."""

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 drop_last: bool = False, base_seed: int = 0):
        self.train_set = np.asarray(train_set, dtype=np.int32)
        self.batch_size = batch_size
        self.seed_cap = seed_cap
        self.base_seed = base_seed
        n = len(self.train_set)
        self.num_step = n // batch_size if drop_last else _num_step(n, batch_size)
        self.drop_last = drop_last

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.base_seed * 1_000_003 + epoch)
        return rng.permutation(self.train_set)

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        """Yield (padded_seeds [seed_cap], num_real, global_step)."""
        perm = self.epoch_permutation(epoch)
        for step in range(self.num_step):
            lo = step * self.batch_size
            hi = min(lo + self.batch_size, len(perm))
            out = np.full(self.seed_cap, -1, dtype=np.int32)
            out[: hi - lo] = perm[lo:hi]
            yield out, hi - lo, step

    def epoch_arrays(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Whole epoch at once: (seeds [num_step, seed_cap], nums
        [num_step]) — one host->device upload per epoch instead of one per
        step."""
        perm = self.epoch_permutation(epoch)
        seeds = np.full((self.num_step, self.seed_cap), -1, dtype=np.int32)
        nums = np.zeros((self.num_step,), dtype=np.int32)
        for step in range(self.num_step):
            lo = step * self.batch_size
            hi = min(lo + self.batch_size, len(perm))
            seeds[step, : hi - lo] = perm[lo:hi]
            nums[step] = hi - lo
        return seeds, nums


class DistShuffler(EpochShuffler):
    """Partition the (identically-shuffled) epoch across sampler workers by
    contiguous step ranges; last worker takes the remainder
    (dist_shuffler.cc:59-79). Global step ids are preserved for batch keys.
    """

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 worker_id: int, num_worker: int, base_seed: int = 0):
        super().__init__(train_set, batch_size, seed_cap, base_seed=base_seed)
        assert 0 <= worker_id < num_worker
        per = self.num_step // num_worker
        self.step_begin = per * worker_id
        self.step_end = (
            self.num_step if worker_id == num_worker - 1 else per * (worker_id + 1)
        )
        self.worker_id = worker_id
        self.num_worker = num_worker

    @property
    def num_local_step(self) -> int:
        return self.step_end - self.step_begin

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        perm = self.epoch_permutation(epoch)
        for step in range(self.step_begin, self.step_end):
            lo = step * self.batch_size
            hi = min(lo + self.batch_size, len(perm))
            out = np.full(self.seed_cap, -1, dtype=np.int32)
            out[: hi - lo] = perm[lo:hi]
            yield out, hi - lo, step


class AlignedDistShuffler(EpochShuffler):
    """arch6/7 shuffler: every worker runs the same number of local steps
    (dist_shuffler_aligned.h:40-64) — strided assignment, padded epoch."""

    def __init__(self, train_set: np.ndarray, batch_size: int, seed_cap: int,
                 worker_id: int, num_worker: int, base_seed: int = 0):
        super().__init__(train_set, batch_size, seed_cap, base_seed=base_seed)
        self.worker_id = worker_id
        self.num_worker = num_worker
        self.num_local_step = _num_step(self.num_step, num_worker)
        self.aligned_num_step = self.num_local_step * num_worker

    def batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, int, int]]:
        perm = self.epoch_permutation(epoch)
        for local in range(self.num_local_step):
            step = local * self.num_worker + self.worker_id
            lo = step * self.batch_size
            hi = min(max(lo, 0) + self.batch_size, len(perm))
            out = np.full(self.seed_cap, -1, dtype=np.int32)
            if lo < len(perm):
                out[: hi - lo] = perm[lo:hi]
                n = hi - lo
            else:
                n = 0
            yield out, n, step
