"""PinSAGE random-walk sampling + per-seed top-K by visit frequency.

Reference: cuda_sampling_random_walk.cu:43-160 (walks; ``restart_prob``
actually *terminates* a walk early) + FrequencyHashmap::GetTopK
(cuda_frequency_hashmap.cu — 1370 LoC of cub radix-sort machinery).

Design: walks are a `lax.scan` over walk steps with a [n_seed, W]
frontier; top-K replaces the GPU hash+radix-sort pipeline with dense
per-row O(M^2) duplicate counting over the tiny M = W*L visit buffer
(default 4*3 = 12) followed by `lax.top_k` — branch-free, static shapes.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import SampleType
from .hashtable import unique_and_remap
from .padding import SamplePlan
from .sampling import Block, CSRGraph, SampledBatch


def random_walk_visits(
    key: jax.Array,
    graph: CSRGraph,
    seeds: jnp.ndarray,
    num_random_walk: int,
    walk_length: int,
    restart_prob: float,
) -> jnp.ndarray:
    """All nodes visited by W walks of length L from each seed.

    Returns [n_seed, W*L] int32 visited node ids, -1 for dead slots.
    """
    n = seeds.shape[0]
    W = num_random_walk
    ptr = graph.indptr
    E = graph.indices.shape[0]

    def step(carry, k):
        node = carry  # [n, W] current frontier, -1 = dead
        alive = node >= 0
        safe = jnp.maximum(node, 0)
        off = ptr[safe]
        deg = (ptr[safe + 1] - off).astype(jnp.int32)
        k1, k2 = jax.random.split(k)
        u = jax.random.uniform(k1, (n, W))
        pick = jnp.minimum(
            jnp.floor(u * deg.astype(u.dtype)).astype(jnp.int32), deg - 1
        )
        flat = jnp.clip(off + jnp.maximum(pick, 0), 0, E - 1)
        from .sampling import take_1d_blocked

        nxt = take_1d_blocked(graph.indices, flat.reshape(-1)).reshape(n, W)
        ok = alive & (deg > 0)
        visited = jnp.where(ok, nxt, -1)
        # terminate with restart_prob (reference kills the walk, :94-97)
        die = jax.random.uniform(k2, (n, W)) < restart_prob
        nxt_node = jnp.where(ok & ~die, visited, -1)
        return nxt_node, visited

    start = jnp.broadcast_to(seeds[:, None], (n, W))
    start = jnp.where(start >= 0, start, -1)
    keys = jax.random.split(key, walk_length)
    _, visits = jax.lax.scan(step, start, keys)
    # visits: [L, n, W] -> [n, W*L]
    return jnp.transpose(visits, (1, 2, 0)).reshape(n, W * walk_length)


def topk_by_frequency(
    visits: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row top-k distinct values by multiplicity.

    visits: [n, M] int32, -1 = dead. Returns (dst [n,k] int32 -1-padded,
    weight [n,k] f32 visit counts) — FrequencyHashmap::GetTopK analog.
    """
    n, M = visits.shape
    eq = visits[:, :, None] == visits[:, None, :]        # [n, M, M]
    valid = visits >= 0
    count = jnp.sum(eq & valid[:, None, :], axis=2)       # [n, M]
    first = jnp.sum(
        eq & (jax.lax.broadcasted_iota(jnp.int32, (n, M, M), 2)
              < jax.lax.broadcasted_iota(jnp.int32, (n, M, M), 1)),
        axis=2,
    ) == 0                                               # no earlier dup
    score = jnp.where(valid & first, count, 0)
    k_eff = min(k, M)
    topv, topi = jax.lax.top_k(score, k_eff)
    dst = jnp.take_along_axis(visits, topi, axis=1)
    ok = topv > 0
    dst = jnp.where(ok, dst, -1)
    w = jnp.where(ok, topv.astype(jnp.float32), 0.0)
    if k_eff < k:
        pad = k - k_eff
        dst = jnp.pad(dst, ((0, 0), (0, pad)), constant_values=-1)
        w = jnp.pad(w, ((0, 0), (0, pad)), constant_values=0.0)
    return dst, w


def random_walk_topk(
    key: jax.Array,
    graph: CSRGraph,
    seeds: jnp.ndarray,
    num_seeds: jnp.ndarray,
    plan: SamplePlan,
    *,
    num_random_walk: int = 4,
    random_walk_length: int = 3,
    restart_prob: float = 0.5,
    dedup_last_hop: bool = True,
) -> SampledBatch:
    """Multi-layer PinSAGE sampling (DoGPUSample with random_walk type).

    Every hop's fanout is plan.fanouts[hop] == K (num_neighbor); edge
    weights are visit counts consumed by WeightedSAGEConv.
    ``dedup_last_hop=False`` mirrors multi_layer_sample's fast mode for
    HBM-resident features.
    """
    cur = seeds
    num_cur = num_seeds
    blocks_rev = []
    overflowed = jnp.zeros((), dtype=bool)

    for hop in range(plan.num_layer):
        K = plan.fanouts[hop]
        k1 = jax.random.fold_in(key, hop)
        visits = random_walk_visits(
            k1, graph, cur, num_random_walk, random_walk_length, restart_prob
        )
        dst_nodes, w = topk_by_frequency(visits, K)       # [n_in, K]
        nbrs = dst_nodes.reshape(-1)
        weights = w.reshape(-1)
        valid = nbrs >= 0

        if hop == plan.num_layer - 1 and not dedup_last_hop:
            S = cur.shape[0]
            E = nbrs.shape[0]
            src_local = jnp.where(
                valid,
                S + jax.lax.broadcasted_iota(
                    jnp.int32, (E, 1), 0
                ).squeeze(-1),
                -1,
            )
            unique = jnp.concatenate([cur, jnp.where(valid, nbrs, -1)])
            num_unique = num_cur + jnp.sum(valid).astype(jnp.int32)
            ovf = jnp.zeros((), bool)
        else:
            unique, num_unique, src_local, ovf = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop]
            )
        overflowed = overflowed | ovf
        dst_local = jax.lax.broadcasted_iota(
            jnp.int32, (plan.num_input_cap[hop], K), 0
        ).reshape(-1)
        mask = valid & (src_local >= 0)
        blocks_rev.append(
            Block(
                src_local=jnp.where(mask, src_local, -1),
                dst_local=jnp.where(mask, dst_local, -1),
                mask=mask,
                num_src=num_unique.astype(jnp.int32),
                num_dst=num_cur.astype(jnp.int32),
                weights=jnp.where(mask, weights, 0.0),
                slots_per_dst=K,
                src_slice_offset=(
                    cur.shape[0]
                    if hop == plan.num_layer - 1 and not dedup_last_hop
                    else None
                ),
            )
        )
        cur = unique
        num_cur = num_unique

    return SampledBatch(
        blocks=tuple(reversed(blocks_rev)),
        input_nodes=cur,
        num_input=num_cur.astype(jnp.int32),
        output_nodes=seeds[: plan.batch_size],
        num_output=num_seeds.astype(jnp.int32),
        overflowed=overflowed,
    )
