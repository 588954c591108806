"""Checkpoint / resume as NumPy archives.

The reference has NO checkpointing (SURVEY.md §5.4 — fixed-epoch benchmark
runs, model state lives in the torch app and is discarded). Here the
engines save (TrainState, epoch) every ``ckpt_every`` epochs and restore
the latest on restart: one ``ckpt_<epoch>.npz`` per save holding the
flattened state leaves, the newest ``max_to_keep`` kept. Restoring
unflattens into the tree structure of a live state, so a checkpoint whose
leaf count, shapes or dtypes differ from the engine's is refused.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import jax
import numpy as np

from ..utils import get_logger

log = get_logger(__name__)

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointManager:
    """One directory, keep-N, (state, epoch) payloads."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _epochs(self):
        return sorted(
            int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
            if m
        )

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch:08d}.npz")

    def save(self, epoch: int, state) -> None:
        leaves = [np.asarray(x) for x in jax.tree.leaves(state)]
        tmp = os.path.join(self.directory, f".tmp_{epoch:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
        os.replace(tmp, self._path(epoch))
        for old in self._epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint: saved epoch %d -> %s", epoch, self.directory)

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self, state_like) -> Optional[Tuple[object, int]]:
        """Restore the latest checkpoint into the structure of
        ``state_like``. Returns (host state, epoch), or None when the
        directory holds no checkpoint."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        like, treedef = jax.tree.flatten(state_like)
        with np.load(self._path(epoch)) as z:
            if len(z.files) != len(like):
                raise ValueError(
                    f"checkpoint {self._path(epoch)} holds {len(z.files)} "
                    f"leaves; the state has {len(like)}"
                )
            leaves = []
            for i, ref in enumerate(like):
                a = z[f"leaf_{i}"]
                want = np.dtype(ref.dtype)
                if a.dtype != want and a.dtype.itemsize == want.itemsize \
                        and a.dtype.kind == "V":
                    a = a.view(want)   # extension dtypes (bfloat16) load raw
                if a.shape != tuple(ref.shape) or a.dtype != want:
                    raise ValueError(
                        f"checkpoint leaf {i} is {a.dtype}{list(a.shape)}; "
                        f"the state has {want}{list(ref.shape)}"
                    )
                leaves.append(a)
        log.info("checkpoint: restored epoch %d from %s", epoch,
                 self.directory)
        return jax.tree.unflatten(treedef, leaves), epoch
