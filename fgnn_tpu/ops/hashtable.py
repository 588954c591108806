"""Dedup + dense renumbering.

Replacement for the reference's GPU ``OrderedHashTable``
(samgraph/common/cuda/cuda_hashtable.{cu,h}): instead of an
open-addressing table with version counters, we use XLA sort/unique —
static shapes, no atomics, deterministic. Semantics preserved:

* ``FillWithUnique(seeds)`` — seeds get local ids [0, n_seed) in *input
  order* (cuda_hashtable.cu FillWithUnique), so layer-(l+1) seeds are a
  prefix of layer-l's source nodes (required for block self-connectivity).
* ``FillWithDuplicates(neighbors)`` — new nodes are appended after the
  seeds; we assign appended locals in *sorted global-id order* (any
  deterministic order is valid — the reference's is kernel-scheduling
  order, which is not meaningful either).

All buffers are statically sized; padding entries are EMPTY_KEY (-1)
externally and INT32_MAX internally (so they sort to the end).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

INT_MAX = jnp.iinfo(jnp.int32).max


def _to_sentinel(x: jnp.ndarray) -> jnp.ndarray:
    """-1 padding -> INT_MAX so padded entries sort last."""
    return jnp.where(x < 0, INT_MAX, x)


def _from_sentinel(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(x == INT_MAX, -1, x)


def unique_with_seeds(
    seeds: jnp.ndarray,
    num_seeds: jnp.ndarray,
    neighbors: jnp.ndarray,
    out_cap: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FillWithDuplicates analog.

    Args:
      seeds: [S] int32, unique ids, -1 padded; locals are their positions.
      num_seeds: scalar int32, count of real seeds.
      neighbors: [E] int32 sampled neighbor ids, -1 padded.
      out_cap: static output capacity (>= S).

    Returns:
      (unique [out_cap] int32 -1-padded — seeds first (input order), then
       new nodes in ascending global id; num_unique scalar; overflowed bool
       scalar — true if new nodes were clipped to capacity.)
    """
    S = seeds.shape[0]
    seeds_s = _to_sentinel(seeds)
    nbr_s = _to_sentinel(neighbors)

    # Drop neighbors already present among seeds: sort seeds once, then
    # binary-search each neighbor (SearchO2N analog).
    order = jnp.argsort(seeds_s)
    sorted_seeds = seeds_s[order]
    pos = jnp.searchsorted(sorted_seeds, nbr_s)
    pos_c = jnp.minimum(pos, S - 1)
    in_seeds = sorted_seeds[pos_c] == nbr_s
    cand = jnp.where(in_seeds, INT_MAX, nbr_s)

    new_cap = max(out_cap - S, 1)
    uniq_new = jnp.unique(cand, size=new_cap, fill_value=INT_MAX)
    num_new = jnp.sum(uniq_new != INT_MAX).astype(jnp.int32)
    # Detect clipping: jnp.unique(size=) silently drops the largest values
    # when there are more uniques than `size`; recount to notice.
    sorted_cand = jnp.sort(cand)
    first_occ = jnp.concatenate(
        [jnp.array([True]), sorted_cand[1:] != sorted_cand[:-1]]
    )
    total_distinct = jnp.sum(first_occ & (sorted_cand != INT_MAX)).astype(jnp.int32)
    overflowed = total_distinct > num_new

    unique = jnp.full((out_cap,), INT_MAX, dtype=jnp.int32)
    unique = unique.at[:S].set(seeds_s)
    unique = unique.at[S:].set(uniq_new[: out_cap - S])
    num_unique = num_seeds + num_new
    return _from_sentinel(unique), num_unique, overflowed


def unique_and_remap(
    seeds: jnp.ndarray,
    num_seeds: jnp.ndarray,
    neighbors: jnp.ndarray,
    out_cap: int,
    with_counts: bool = False,
):
    """Fused FillWithDuplicates + GPUMapEdges in ONE sort.

    The hot path of DoGPUSample (cuda_loops.cc:176-204 does hashtable
    insert + remap as separate kernel pipelines; we fuse them): sort the
    concatenated [seeds | neighbors] once by (value, is_neighbor), derive
    group leaders, assign locals (seed leaders keep their input position,
    new leaders get S + rank), propagate to group members, and scatter
    locals back through the sort permutation.

    Returns (unique [out_cap] -1-padded seeds-first, num_unique,
    nbr_local [E] int32 — local id per neighbor slot (-1 for padding),
    overflowed bool).

    ``with_counts=True`` appends a 5th output ``counts [out_cap] int32``:
    the multiplicity of each unique node among the (valid) neighbor
    stream — exactly the block's src out-degree, which GCN's norm='both'
    needs. Computed from the SAME sort (group run lengths via a reverse
    cummin, then one extra (key,value) sort aligns counts with local ids
    — new leaders' locals are consecutive in sorted order, so sorting by
    leader-local IS the compaction). This replaces a [E]-sized
    scatter-add (``out_degrees``).
    """
    S = seeds.shape[0]
    E = neighbors.shape[0]
    assert out_cap >= S
    assert S + E < (1 << 24), "position field overflow"
    arr = jnp.concatenate([_to_sentinel(seeds), _to_sentinel(neighbors)])
    tag = jnp.concatenate(
        [jnp.zeros(S, jnp.int32), jnp.ones(E, jnp.int32)]
    )
    pos = jax.lax.broadcasted_iota(jnp.int32, (S + E, 1), 0).squeeze(-1)
    # pack (tag:1 | pos:24) into the secondary key: 8B/element instead of
    # 12B and no is_stable flag (unique pos bits already make the order
    # deterministic). int64 packing is unavailable (x64 disabled).
    tagpos = (tag << 24) | pos
    sa, stp = jax.lax.sort((arr, tagpos), num_keys=2)
    st = stp >> 24
    sp = stp & ((1 << 24) - 1)

    first = jnp.concatenate([jnp.array([True]), sa[1:] != sa[:-1]])
    is_pad = sa == INT_MAX
    new_leader = first & (st == 1) & (~is_pad)
    new_rank = jnp.cumsum(new_leader.astype(jnp.int32)) - 1
    leader_local = jnp.where(st == 0, sp, S + new_rank)

    # propagate each group's leader position forward, then gather its local
    idx = jax.lax.broadcasted_iota(jnp.int32, (S + E, 1), 0).squeeze(-1)
    lead_idx = jax.lax.cummax(jnp.where(first, idx, 0))
    prop = leader_local[lead_idx]
    local_sorted = jnp.where(is_pad, -1, prop)

    # overflow: appended locals beyond out_cap are clipped to -1
    local_sorted = jnp.where(local_sorted >= out_cap, -1, local_sorted)
    num_new = jnp.sum(new_leader).astype(jnp.int32)
    overflowed = (S + num_new) > out_cap

    # unscatter through the (permutation) sort order
    local_all = jnp.zeros(S + E, jnp.int32).at[sp].set(
        local_sorted, unique_indices=True
    )
    nbr_local = local_all[S:]

    # unique list: seeds block + scattered new leaders
    unique = jnp.full((out_cap,), INT_MAX, jnp.int32).at[:S].set(
        _to_sentinel(seeds)
    )
    tgt = jnp.where(new_leader, S + new_rank, out_cap)  # out-of-range drops
    unique = unique.at[tgt].set(
        jnp.where(new_leader, sa, INT_MAX), mode="drop"
    )
    num_unique = num_seeds + jnp.minimum(
        num_new, jnp.int32(out_cap - S)
    )
    if not with_counts:
        return _from_sentinel(unique), num_unique, nbr_local, overflowed

    n = S + E
    # group sizes: distance from each leader to the next leader. cummin
    # in reverse gives the nearest group-start at-or-after each position.
    nf = jax.lax.cummin(jnp.where(first, idx, n), reverse=True)
    nxt_after = jnp.concatenate([nf[1:], jnp.full((1,), n, nf.dtype)])
    grp = nxt_after - idx                       # meaningful at leaders
    cnt = jnp.where(is_pad, 0, grp - (st == 0)) # seed leader: drop itself
    # align counts with LOCAL ids via one (key, value) sort:
    #  * every seed slot (real or padded) keys at its position sp < S so
    #    the seed region stays dense (padded seeds carry count 0),
    #  * new leaders key at their local S + rank (consecutive),
    #  * everything else (non-leader, clipped, pad) keys at n, after all
    #    real locals.
    key = jnp.where(
        st == 0,
        sp,
        jnp.where(
            first & (~is_pad) & (leader_local < out_cap), leader_local, n
        ),
    )
    cnt = jnp.where((st == 0) & (~first), 0, cnt)  # padded dup seeds
    skey, scnt = jax.lax.sort([key, cnt], num_keys=1)
    m = min(out_cap, n)  # out_cap may exceed the S+E stream length
    counts = jnp.zeros((out_cap,), jnp.int32).at[:m].set(
        jnp.where(skey[:m] < n, scnt[:m], 0).astype(jnp.int32)
    )
    return _from_sentinel(unique), num_unique, nbr_local, overflowed, counts


def unique_and_remap_direct(
    seeds: jnp.ndarray,
    num_seeds: jnp.ndarray,
    neighbors: jnp.ndarray,
    out_cap: int,
    num_node: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sort-free FillWithDuplicates + GPUMapEdges via a direct-index table.

    Analog of the reference's ``SXN_NAIVE_HASHMAP`` direct-index
    OrderedHashTable variant (cuda_hashtable.h:70-94): a [num_node]
    scratch in device memory replaces the O((S+E) log^2) XLA sort with
    O(N + E) scatter/gather/cumsum. Memory: 4B * num_node
    per call (alive only inside the fused program); use the sort-based
    :func:`unique_and_remap` for graphs where that scratch doesn't fit.

    Same contract as :func:`unique_and_remap`: seeds keep their input
    positions as locals, new nodes are appended in ascending global id
    (cumsum order == id order), clipped at out_cap with overflow flag.
    """
    S = seeds.shape[0]
    seeds_ok = seeds >= 0
    nbr_ok = neighbors >= 0
    safe_seeds = jnp.where(seeds_ok, seeds, 0)
    safe_nbr = jnp.where(nbr_ok, neighbors, 0)
    # padded entries scatter to index num_node -> dropped (never clobber
    # a real node's slot)
    tgt_seeds = jnp.where(seeds_ok, seeds, num_node)
    tgt_nbr = jnp.where(nbr_ok, neighbors, num_node)

    # seed locals: table[v] = position of v among seeds, else -1
    seed_local = jnp.full((num_node,), -1, jnp.int32)
    seed_local = seed_local.at[tgt_seeds].set(
        jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0).squeeze(-1),
        mode="drop",
    )

    # mark neighbor-visited nodes that are NOT seeds
    present = jnp.zeros((num_node,), jnp.bool_)
    present = present.at[tgt_nbr].set(True, mode="drop")
    present = present & (seed_local < 0)

    # dense ranks for new nodes, in ascending node id
    rank = jnp.cumsum(present.astype(jnp.int32))          # inclusive
    num_new = rank[-1]
    new_local_tab = S + rank - 1                          # valid where present

    nbr_seed_loc = seed_local[safe_nbr]
    nbr_new_loc = new_local_tab[safe_nbr]
    local = jnp.where(nbr_seed_loc >= 0, nbr_seed_loc, nbr_new_loc)
    local = jnp.where(local >= out_cap, -1, local)        # clipped
    nbr_local = jnp.where(nbr_ok, local, -1)

    # unique list: seeds block, then new nodes compacted by rank
    unique = jnp.full((out_cap,), INT_MAX, jnp.int32).at[:S].set(
        _to_sentinel(seeds)
    )
    ids = jax.lax.broadcasted_iota(jnp.int32, (num_node, 1), 0).squeeze(-1)
    tgt = jnp.where(present, S + rank - 1, out_cap)       # out-of-range drops
    unique = unique.at[tgt].set(jnp.where(present, ids, INT_MAX), mode="drop")

    overflowed = (S + num_new) > out_cap
    num_unique = num_seeds + jnp.minimum(num_new, jnp.int32(out_cap - S))
    return _from_sentinel(unique), num_unique, nbr_local, overflowed


def lookup_local_ids(
    unique: jnp.ndarray,
    num_seeds_static: int,
    queries: jnp.ndarray,
) -> jnp.ndarray:
    """SearchO2N / GPUMapEdges analog: map global ids -> local dense ids.

    ``unique`` must be laid out as produced by :func:`unique_with_seeds`
    (seeds occupying [0, num_seeds_static) in arbitrary order, the rest
    ascending). Queries not present map to -1 (padding queries of -1 too).
    """
    S = num_seeds_static
    seeds_s = _to_sentinel(unique[:S])
    rest = _to_sentinel(unique[S:])
    q = _to_sentinel(queries)

    # seeds: sorted copy + original positions
    order = jnp.argsort(seeds_s)
    sorted_seeds = seeds_s[order]
    p = jnp.searchsorted(sorted_seeds, q)
    p_c = jnp.minimum(p, S - 1)
    hit_seed = sorted_seeds[p_c] == q
    local_seed = order[p_c].astype(jnp.int32)

    # appended region is ascending already. It is statically EMPTY when
    # the unique cap equals the seed cap (last-hop plans clamped at
    # num_node) — skip the search, nothing can hit there.
    if rest.shape[0]:
        p2 = jnp.searchsorted(rest, q)
        p2_c = jnp.minimum(p2, rest.shape[0] - 1)
        hit_rest = rest[p2_c] == q
        local_rest = (S + p2_c).astype(jnp.int32)
    else:
        hit_rest = jnp.zeros(q.shape, dtype=bool)
        local_rest = jnp.full(q.shape, -1, dtype=jnp.int32)

    local = jnp.where(hit_seed, local_seed, jnp.where(hit_rest, local_rest, -1))
    return jnp.where(q == INT_MAX, -1, local)
