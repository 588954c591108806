"""Dynamic feature cache (arch4 analog).

Reference: GPUDynamicCacheManager (cuda_cache_manager.h:81-132) +
DoGPUSampleDyCache / DoDynamicCacheFeatureCopy (cuda_loops.cc:269-498,
1124-1295): instead of a static hot-set, the cache is *replaced every
step* with the previous batch's gathered features — exploiting
batch-to-batch overlap of input nodes.

Design: the cache state is a pytree carried between steps — the
previous batch's (sorted ids, permutation, features) all device-resident;
membership is a searchsorted against the sorted ids (replacing the
rebuilt GPU hashtable), and the combine is gather-only like the static
manager.

Prefetch pipeline (the reference's DoGPUSampleDyCache early-enqueue,
cuda_loops_arch4.cc:69-73): the miss SPLIT of batch k+1 depends only on
batch k's *ids* — not its features — so ``split_and_advance`` advances
the id-state eagerly and the host miss gather of batch k+1 can run while
batch k trains. ``combine`` then fills in the feature half of the state.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import pytree_dataclass

INT_MAX = jnp.iinfo(jnp.int32).max


@pytree_dataclass
class DynCacheState:
    ids_sorted: jnp.ndarray   # [cap] int32, ascending, INT_MAX padded
    row: jnp.ndarray          # [cap] int32: feats row for ids_sorted[i]
    feats: jnp.ndarray        # [cap, F] previous batch's features


class DynSplit(NamedTuple):
    """One batch's hit/miss classification vs the previous batch."""

    input_nodes: jnp.ndarray
    hit: jnp.ndarray
    cache_row: jnp.ndarray
    rank: jnp.ndarray
    miss_ids: jnp.ndarray
    num_miss: jnp.ndarray


def init_state(cap: int, feat_dim: int) -> DynCacheState:
    return DynCacheState(
        ids_sorted=jnp.full((cap,), INT_MAX, jnp.int32),
        row=jnp.zeros((cap,), jnp.int32),
        feats=jnp.zeros((cap, feat_dim), jnp.float32),
    )


def ids_from(input_nodes: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The id half of the next cache state — available as soon as the
    batch is sampled, before its features exist."""
    q = jnp.where(input_nodes < 0, INT_MAX, input_nodes)
    order = jnp.argsort(q)
    return q[order], order.astype(jnp.int32)


def split_hits(
    ids_sorted: jnp.ndarray, row: jnp.ndarray, input_nodes: jnp.ndarray
) -> DynSplit:
    """Jittable hit/miss split vs the previous batch's ids."""
    cap = ids_sorted.shape[0]
    q = jnp.where(input_nodes < 0, INT_MAX, input_nodes)
    p = jnp.clip(jnp.searchsorted(ids_sorted, q), 0, cap - 1)
    hit = (ids_sorted[p] == q) & (q != INT_MAX)
    cache_row = jnp.where(hit, row[p], 0)

    valid = input_nodes >= 0
    miss = valid & ~hit
    sort_key = jnp.where(miss, 0, jnp.where(hit, 1, 2)).astype(jnp.int32)
    order = jnp.argsort(sort_key, stable=True)
    rank = jnp.argsort(order, stable=True).astype(jnp.int32)
    miss_ids = jnp.where(sort_key[order] == 0, input_nodes[order], -1)
    return DynSplit(
        input_nodes=input_nodes,
        hit=hit,
        cache_row=cache_row,
        rank=rank,
        miss_ids=miss_ids.astype(jnp.int32),
        num_miss=jnp.sum(miss),
    )


def combine_feats(
    prev_feats: jnp.ndarray,
    split: DynSplit,
    miss_feat: jnp.ndarray,
) -> jnp.ndarray:
    """Combine hit rows (from the previous batch's features) with the
    host-gathered miss rows — one fused gather program
    (DoDynamicCacheFeatureCopy + ReplaceCacheGPU analog). The result IS
    the next state's feature half (input order, matching ids_from's row)."""
    cache_part = jnp.take(prev_feats, split.cache_row, axis=0, mode="clip")
    miss_part = jnp.take(miss_feat, split.rank, axis=0, mode="clip")
    out = jnp.where(split.hit[:, None], cache_part, miss_part)
    return jnp.where((split.input_nodes >= 0)[:, None], out, 0)


class DynamicFeatureCache:
    """Host-side orchestration wrapper (engine-facing API parity with
    FeatureCache).

    Staged API for the arch4 prefetch pipeline: ``split_and_advance``
    (device, advances the id-state), ``gather_miss`` (host, thread-safe),
    ``combine`` (device, advances the feature-state). ``extract`` chains
    the three synchronously — identical math by construction.
    """

    def __init__(self, feat_host: np.ndarray, cap: int, mod: int = 0):
        self.feat_host = feat_host
        # empty-feat modulo (CPUMockExtract analog); pass ds.feat_mod
        self.mod = mod
        self.state = init_state(cap, feat_host.shape[1])
        self._split = jax.jit(split_hits)
        self._ids_from = jax.jit(ids_from)
        self._combine = jax.jit(combine_feats)

    # -- staged ----------------------------------------------------------
    def split_and_advance(self, input_nodes: jnp.ndarray) -> DynSplit:
        """Classify this batch vs the previous batch's ids, then advance
        the id-state to THIS batch (its features arrive at combine).
        The next call classifies against this batch — which is what lets
        the miss gather of batch k+1 overlap the training of batch k."""
        split = self._split(self.state.ids_sorted, self.state.row,
                            input_nodes)
        ids_sorted, row = self._ids_from(input_nodes)
        self.state = self.state.replace(ids_sorted=ids_sorted, row=row)
        return split

    def gather_miss(self, miss_ids: np.ndarray, n_miss: int) -> np.ndarray:
        """Host gather of miss rows (ExtractMissData analog); safe to run
        on a worker thread — touches no cache state."""
        from .. import native

        ids_np = np.asarray(miss_ids)
        if self.mod:
            ids_np = np.where(ids_np >= 0, ids_np % self.mod, ids_np)
        if native.available() and self.feat_host.dtype == np.float32:
            return native.gather_f32(self.feat_host, ids_np, n_real=n_miss)
        miss = np.zeros((len(ids_np), self.feat_host.shape[1]), np.float32)
        if n_miss:
            miss[:n_miss] = self.feat_host[np.maximum(ids_np[:n_miss], 0)]
        return miss

    def combine(self, split: DynSplit, miss_feat: jnp.ndarray) -> jnp.ndarray:
        """Merge hits+misses and install the result as the new cache
        features (the feature half of the state advanced at split time)."""
        out = self._combine(self.state.feats, split, miss_feat)
        self.state = self.state.replace(feats=out)
        self.last_num_miss = int(split.num_miss)
        self.last_num_hit = int(jnp.sum(split.hit))
        return out

    # -- synchronous (engine fallback + tests) -----------------------------
    def extract(self, input_nodes: jnp.ndarray) -> jnp.ndarray:
        split = self.split_and_advance(input_nodes)
        n_miss = int(split.num_miss)
        miss = self.gather_miss(np.asarray(split.miss_ids), n_miss)
        return self.combine(split, jnp.asarray(miss))
