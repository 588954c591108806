"""Device feature cache manager.

Analog of GPUCacheManager / DistCacheManager
(cuda/cuda_cache_manager_{host.cc,device.cu}, dist/dist_cache_manager_*):
the hottest ``cache_percentage * num_node`` vertices' features live in
trainer device memory; misses are gathered host-side and merged on
device.

Redesign of the count/scan/compact index kernels
(cuda_cache_manager_device.cu:266-338): the miss/hit split is a stable
argsort on the hit flag (misses first), and the final combine is pure
gathers — ``out[i] = hit[i] ? cache_data[slot[i]] : miss_feat[rank[i]]``
— no scatter, no dynamic shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import Timer, get_logger, pytree_dataclass
from ..utils.profiler import Profiler

log = get_logger(__name__)


@pytree_dataclass
class MissCacheIndex:
    """DoGetCacheMissIndex output (dist_loops.cc:271-323 analog): the split
    shipped from sampler to trainer so the trainer never touches the full
    id list."""

    miss_ids: jnp.ndarray      # [cap] int32 global ids, misses compacted front, -1 pad
    rank: jnp.ndarray          # [cap] int32: position of input i in miss-first order
    hit: jnp.ndarray           # [cap] bool
    slot: jnp.ndarray          # [cap] int32 cache slot (valid where hit)
    num_miss: jnp.ndarray      # scalar int32
    num_hit: jnp.ndarray       # scalar int32


def miss_cache_index(
    cache_table: jnp.ndarray, input_nodes: jnp.ndarray
) -> MissCacheIndex:
    """Pure jittable miss/hit split (GetMissCacheIndex analog). The table
    enters as an argument so jitted callers don't embed it as an HLO
    constant."""
    valid = input_nodes >= 0
    slot = jnp.where(
        valid, cache_table[jnp.maximum(input_nodes, 0)], -1
    )
    hit = slot >= 0
    miss = valid & ~hit
    # stable partition: misses first, then hits, then padding
    sort_key = jnp.where(miss, 0, jnp.where(hit, 1, 2)).astype(jnp.int32)
    order = jnp.argsort(sort_key, stable=True)
    rank = jnp.argsort(order, stable=True).astype(jnp.int32)
    miss_ids = jnp.where(
        sort_key[order] == 0, input_nodes[order], -1
    ).astype(jnp.int32)
    return MissCacheIndex(
        miss_ids=miss_ids,
        rank=rank,
        hit=hit,
        slot=slot,
        num_miss=jnp.sum(miss).astype(jnp.int32),
        num_hit=jnp.sum(hit).astype(jnp.int32),
    )


class FeatureCache:
    """Static feature cache (GPUCacheManager analog)."""

    def __init__(
        self,
        feat_host: np.ndarray,          # full feature matrix (mmap ok)
        ranking: np.ndarray,            # hottest-first node permutation
        cache_percentage: float,
        num_node: int,
        dtype=None,                     # staging dtype (jnp.bfloat16 halves
                                        # host->device miss traffic)
        empty_feat: bool = False,       # explicit Dataset.empty_feat flag
    ):
        t = Timer()
        self.num_node = num_node
        self.num_cache = int(cache_percentage * num_node)
        self.cache_percentage = cache_percentage
        self.dtype = dtype or jnp.float32
        self.ranking = np.asarray(ranking, dtype=np.int32)
        cache_nodes = np.asarray(ranking[: self.num_cache], dtype=np.int32)
        # node id -> cache slot (or -1); the sampler-side hashtable
        # (SampleCacheTableInit, dist_engine.cc:193-229)
        table = np.full((num_node + 1,), -1, dtype=np.int32)
        if self.num_cache:
            table[cache_nodes] = np.arange(self.num_cache, dtype=np.int32)
        self.cache_table = jnp.asarray(table)
        # empty-feat fake table (smaller than the graph): index modulo,
        # like GPUMockExtract (cuda_extraction.cu:51-72). The mode is an
        # EXPLICIT flag — a short feature matrix without it is corrupt
        # data, not a mock.
        if feat_host.shape[0] < num_node and not empty_feat:
            raise ValueError(
                f"feature matrix has {feat_host.shape[0]} rows for "
                f"{num_node} nodes; pass empty_feat=True only for an "
                "intentional mock table (SAMGRAPH_EMPTY_FEAT analog)"
            )
        self._mod = feat_host.shape[0] if empty_feat else 0
        # HBM-resident hot features (trainer-side blob, cache_manager_host.cc)
        if self.num_cache:
            rows = cache_nodes % self._mod if self._mod else cache_nodes
            self.cache_data = jnp.asarray(feat_host[rows],
                                          dtype=self.dtype)
        else:
            self.cache_data = jnp.zeros((1, feat_host.shape[1]), self.dtype)
        self.feat_host = feat_host
        Profiler.get().log_init("init_build_cache", t.passed())
        log.info(
            "feature cache: %d/%d nodes (%.1f%%) = %.1f MB HBM in %.2fs",
            self.num_cache, num_node, 100 * cache_percentage,
            self.cache_data.size * 4 / 2**20, t.passed(),
        )

    # -- jittable ----------------------------------------------------------
    def get_miss_cache_index(self, input_nodes: jnp.ndarray) -> MissCacheIndex:
        """Split ids into hits/misses (GetMissCacheIndex analog). Jittable;
        typically runs on the SAMPLER chip in arch5 so only the split
        crosses the queue."""
        return miss_cache_index(self.cache_table, input_nodes)

    def combine(
        self,
        index: MissCacheIndex,
        miss_feat: jnp.ndarray,          # [cap, F] rows [0,num_miss) real
    ) -> jnp.ndarray:
        """CombineMissData + CombineCacheData (device.cu:166-211) as one
        gather: out[i] = hit ? cache_data[slot] : miss_feat[rank[i]]."""
        cache_part = jnp.take(
            self.cache_data, jnp.maximum(index.slot, 0), axis=0, mode="clip"
        )
        miss_part = jnp.take(miss_feat, index.rank, axis=0, mode="clip")
        out = jnp.where(index.hit[:, None], cache_part, miss_part)
        return jnp.where((index.slot != -2)[:, None], out, 0)

    # -- host --------------------------------------------------------------
    def host_extract_miss(self, miss_ids: np.ndarray, num_miss: int) -> np.ndarray:
        """ExtractMissData (host OpenMP gather analog): gather only the
        first ``num_miss`` rows; the padded tail is zeros."""
        from .. import native

        if self._mod:
            miss_ids = np.where(miss_ids >= 0, miss_ids % self._mod,
                                miss_ids).astype(miss_ids.dtype)
        if native.available() and self.feat_host.dtype == np.float32:
            out = native.gather_f32(self.feat_host, miss_ids, n_real=num_miss)
        else:
            out = np.zeros((len(miss_ids), self.feat_host.shape[1]),
                           dtype=np.float32)
            if num_miss:
                ids = miss_ids[:num_miss]
                out[:num_miss] = self.feat_host[np.maximum(ids, 0)]
        if self.dtype != jnp.float32:
            import ml_dtypes

            out = out.astype(ml_dtypes.bfloat16)   # halve the upload
        return out

    def upload_miss(self, index: MissCacheIndex, num_miss=None,
                    device=None, trace_key=None):
        """Bucketed miss upload: fetch only a power-of-2 slice of the miss
        ids, host-gather, and H2D that bucket — NOT the full unique cap.
        At papers100M caps the cap-padded upload is ~230MB/step while the
        real misses at a ~99% hit rate are ~1MB. A handful of bucket
        shapes keeps combine()'s compile cache small (combine's
        clip-mode take accepts any miss row count >= num_miss).

        Returns (miss rows on device [bucket, F], num_miss).
        """
        if num_miss is None:
            num_miss = int(index.num_miss)   # syncs the split
        cap = int(index.miss_ids.shape[0])
        b = 1024
        while b < num_miss:
            b *= 2
        b = min(b, cap)
        prof = Profiler.get()
        tracing = trace_key is not None and prof.trace_enabled
        t = Timer() if tracing else None
        ids = np.asarray(index.miss_ids[:b])
        miss = self.host_extract_miss(ids, num_miss)
        if tracing:
            # host gather of the miss rows (ExtractMissData analog)
            prof.trace_event(trace_key, "kL3Event_Copy_CacheCopy_ExtractMiss",
                             t._start * 1e6, Timer.now_us())
            t.reset()
        out = (jax.device_put(miss, device) if device is not None
               else jax.device_put(miss))
        if tracing:
            jax.block_until_ready(out)
            prof.trace_event(trace_key, "kL3Event_Copy_CacheCopy_CopyMiss",
                             t._start * 1e6, Timer.now_us())
        return out, num_miss

    def hit_rate(self, index: MissCacheIndex) -> float:
        h = float(index.num_hit)
        m = float(index.num_miss)
        return h / max(h + m, 1.0)
