"""Neighborhood sampling — jittable, static-shape.

Replacement for the reference's CUDA sampling kernels
(samgraph/common/cuda/cuda_sampling_*.cu) as static-shape XLA programs.
Key design differences from the CUDA code:

* Static shapes: each hop emits exactly ``num_input_cap * fanout`` edge
  slots, padded with -1 (EMPTY_KEY) — the CUDA kernels' kEmptyKey +
  count/scan/compact pipeline (cuda_sampling_khop0.cu:92-174) becomes a
  mask; compaction is unnecessary because downstream ops are mask-aware.
* Functional RNG: `jax.random` keys folded per (step, layer) replace the
  persistent curandState array (cuda_random_states.cu). khop2's in-place
  Fisher-Yates swap of the CSR `indices` (cuda_sampling_khop2.cu:44-91 —
  which mutates the graph across batches!) is replaced by Floyd's
  algorithm, which draws the identical uniform-without-replacement
  distribution with no mutation.
* khop0 (reservoir, cuda_sampling_khop0.cu:42-90) and khop2 both sample
  uniformly *without* replacement — one implementation serves both.
  khop1 (cuda_sampling_khop1.cu:42-72) samples *with* replacement.

Weighted variants use the dataset's per-edge alias tables / prefix-sum
tables exactly like cuda_sampling_weighted_khop{,_prefix}.cu.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from ..config import SampleType
from ..utils.pytree import pytree_dataclass, static_field
from .hashtable import unique_and_remap, unique_and_remap_direct
from .padding import SamplePlan

# Direct-index dedup (SXN_NAIVE_HASHMAP analog) — kept for parity,
# DEFAULT OFF: the one-sort path is the default until the two are
# compared on the GPU (it needs a 2M-index scatter into a [num_node]
# table). Opt in via env.
import os as _os
DIRECT_REMAP_MAX_NODES = int(
    _os.environ.get("FGNN_TPU_DIRECT_REMAP_MAX_NODES", "0")
)


@pytree_dataclass
class CSRGraph:
    """Device-resident CSR topology (Dataset topology subset)."""

    indptr: jnp.ndarray   # [N+1] int32/int64
    indices: jnp.ndarray  # [E] int32
    prob_table: Optional[jnp.ndarray] = None         # [E] f32 (alias method)
    alias_table: Optional[jnp.ndarray] = None        # [E] i32
    prob_prefix_table: Optional[jnp.ndarray] = None  # [E] f32

    @property
    def num_node(self) -> int:
        return self.indptr.shape[0] - 1


@pytree_dataclass
class Block:
    """One sampled bipartite layer (TrainGraph analog, common.h:186-196).

    Edges point neighbor(src) -> seed(dst); dst-local ids are a prefix of
    the src-local id space (seeds-first invariant of the hashtable).

    ``slots_per_dst`` (static) marks REGULAR blocks: edge slot
    ``d * slots_per_dst + j`` belongs to dst ``d``. All khop and
    random-walk samplers emit this layout, letting aggregation run as a
    dense reshape+reduce instead of a scatter-add (no atomics, and a
    fixed summation order).
    """

    src_local: jnp.ndarray   # [E_cap] int32, -1 padded
    dst_local: jnp.ndarray   # [E_cap] int32, -1 padded
    mask: jnp.ndarray        # [E_cap] bool
    num_src: jnp.ndarray     # scalar int32 (real count)
    num_dst: jnp.ndarray     # scalar int32
    weights: Optional[jnp.ndarray] = None  # [E_cap] f32 (PinSAGE)
    # src out-degrees BY LOCAL ID (len = src space cap), emitted by the
    # dedup sort when the model needs them (GCN norm='both') — replaces
    # a per-edge scatter-add in models.aggregate.out_degrees
    src_out_deg: Optional[jnp.ndarray] = None
    slots_per_dst: Optional[int] = static_field()
    # no-dedup fast mode (STATIC): edge slot j's src row is exactly
    # h[src_slice_offset + j] — gather_src becomes a free slice. XLA
    # cannot recover this from src_local (the -1 padding hides the iota
    # pattern), and the difference is a 2M-row gather per step.
    src_slice_offset: Optional[int] = static_field()
    # degree-tiered layout (STATIC): edges are laid out as
    # [cap_0 x w_0 | cap_1 x w_1 | ...] over a degree-partitioned
    # frontier (``tier_split`` = ((cap, width), ...)): aggregation runs
    # per tier as a dense reshape+reduce, concatenates in tier order
    # [sum(cap), D], then one [V]-row gather with ``dst_invperm``
    # restores original dst order. ``dst_local`` stores ORIGINAL
    # frontier positions so every generic (segment/sanity) consumer
    # keeps working unchanged.
    tier_split: Optional[Tuple[Tuple[int, int], ...]] = static_field()
    dst_invperm: Optional[jnp.ndarray] = None   # [V] int32

    @property
    def src_cap(self) -> int:
        return -1  # set via shapes; use shape accessors below

    @property
    def num_edge_cap(self) -> int:
        return self.src_local.shape[0]


@pytree_dataclass
class SampledBatch:
    """Task analog (common.h:205-225): one mini-batch's sampled graph.

    ``blocks[0]`` is the input-side (deepest) layer, matching the DGL block
    order the reference's models consume (torch/adapter.py:99-118).
    """

    blocks: Tuple[Block, ...]
    input_nodes: jnp.ndarray    # [final_cap] int32 global ids, -1 padded
    num_input: jnp.ndarray      # scalar int32
    output_nodes: jnp.ndarray   # [B] int32 global seed ids, -1 padded
    num_output: jnp.ndarray     # scalar int32
    overflowed: jnp.ndarray     # scalar bool — any layer clipped its cap


# ---------------------------------------------------------------------------
# per-hop neighbor index selection
# ---------------------------------------------------------------------------

def _floyd_without_replacement(
    key: jax.Array, deg: jnp.ndarray, fanout: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform sample of min(deg, fanout) distinct slots from [0, deg).

    Robert Floyd's algorithm, unrolled over the (static, small) fanout:
    for j in [0, f): J = deg-f+j; draw t ~ U[0, J]; pick t unless already
    picked, else pick J. Equivalent in distribution to the reference's
    reservoir (khop0) and Fisher-Yates (khop2) samplers.
    """
    n = deg.shape[0]
    u = jax.random.uniform(key, (n, fanout))
    big = deg >= fanout
    col = jax.lax.broadcasted_iota(jnp.int32, (n, fanout), 1)

    # rolled loop (fori_loop, not Python unroll): keeps the compiled
    # program O(1) in fanout — the unrolled version compiled to ~f^2 ops
    # and blew up XLA compile time at fanout 25
    def body(j, picks):
        J = deg - fanout + j                       # >= 0 when big
        uj = jax.lax.dynamic_slice_in_dim(u, j, 1, axis=1)[:, 0]
        t = jnp.minimum(
            jnp.floor(uj * (J + 1).astype(u.dtype)).astype(jnp.int32), J
        )
        collided = jnp.any((picks == t[:, None]) & (col < j), axis=1)
        t = jnp.where(collided, J, t)
        small_pick = jnp.where(j < deg, j, -1)     # deg < fanout: take all
        val = jnp.where(big, t, small_pick)
        return jnp.where(col == j, val[:, None], picks)

    picks = jax.lax.fori_loop(
        0, fanout, body, jnp.full((n, fanout), -1, dtype=jnp.int32)
    )
    valid = picks >= 0
    return picks, valid


def _with_replacement(
    key: jax.Array, deg: jnp.ndarray, fanout: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    n = deg.shape[0]
    u = jax.random.uniform(key, (n, fanout))
    idx = jnp.floor(u * deg[:, None].astype(u.dtype)).astype(jnp.int32)
    idx = jnp.minimum(idx, deg[:, None] - 1)
    valid = jnp.broadcast_to((deg > 0)[:, None], idx.shape)
    return jnp.where(valid, idx, -1), valid


def _weighted_alias(
    key: jax.Array,
    deg: jnp.ndarray,
    off,
    graph: CSRGraph,
    fanout: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Alias-method weighted with replacement
    (cuda_sampling_weighted_khop.cu)."""
    n = deg.shape[0]
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n, fanout))
    u2 = jax.random.uniform(k2, (n, fanout))
    slot = jnp.minimum(
        jnp.floor(u1 * deg[:, None].astype(u1.dtype)).astype(jnp.int32),
        deg[:, None] - 1,
    )
    flat = off[:, None] + slot
    flat_c = jnp.clip(flat, 0, graph.indices.shape[0] - 1)
    prob = take_1d_blocked(
        graph.prob_table, flat_c.reshape(-1)
    ).reshape(flat_c.shape)
    alias = take_1d_blocked(
        graph.alias_table, flat_c.reshape(-1)
    ).reshape(flat_c.shape)
    idx = jnp.where(u2 < prob, slot, alias)
    valid = jnp.broadcast_to((deg > 0)[:, None], idx.shape)
    return jnp.where(valid, idx, -1), valid


def _weighted_prefix(
    key: jax.Array,
    deg: jnp.ndarray,
    off,
    graph: CSRGraph,
    fanout: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Binary search on per-vertex prefix sums
    (cuda_sampling_weighted_khop_prefix.cu)."""
    n = deg.shape[0]
    prefix = graph.prob_prefix_table
    E = prefix.shape[0]
    last = jnp.clip(off + deg - 1, 0, E - 1)
    total = jnp.where(deg > 0, prefix[last], 0.0)
    u = jax.random.uniform(key, (n, fanout)) * total[:, None]

    # 32-step binary search over [0, deg) for smallest j: prefix[off+j] >= u
    lo = jnp.zeros((n, fanout), dtype=jnp.int32)
    hi = jnp.broadcast_to(deg[:, None], (n, fanout)).astype(jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        flat = jnp.clip(off[:, None] + mid, 0, E - 1)
        pm = prefix[flat]
        go_right = pm < u
        return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

    lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
    idx = jnp.minimum(lo, deg[:, None] - 1)
    valid = jnp.broadcast_to((deg > 0)[:, None], idx.shape)
    return jnp.where(valid, idx, -1), valid


# oversampling rounds for the large-degree branch of the hash-dedup
# sampler: T = ROUNDS * fanout alias draws, first-`fanout`-distinct kept.
HASHDEDUP_ROUNDS = int(_os.environ.get("FGNN_TPU_HASHDEDUP_ROUNDS", "4"))
# degree bound for the exact Gumbel branch (weight window spans at most
# two 128-lane rows of the per-vertex prefix table)
_GUMBEL_MAX_DEG = 128


def _first_k_distinct(
    idx: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per row, the first k distinct values of `idx` in draw order.

    The set of the first k distinct values of an i.i.d. weighted stream is
    exactly a weighted sample WITHOUT replacement (Efraimidis-Spirakis) —
    the same distribution the reference's rejection loop produces
    (cuda_sampling_weighted_khop_hash_dedup.cu:96-109), conditional on the
    stream containing >= k distinct values.

    Returns (picks [n,k], valid [n,k]); short rows (< k distinct in the
    stream) pad with -1/False.
    """
    n, T = idx.shape
    order = jnp.argsort(idx, axis=-1, stable=True)          # by value, ties by pos
    sv = jnp.take_along_axis(idx, order, axis=-1)
    first = jnp.concatenate(
        [jnp.ones((n, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
    )
    # first-occurrence positions of each distinct value; T = "no value"
    fpos = jnp.where(first, order, T)
    spos = jnp.sort(fpos, axis=-1)[:, :k]                   # draw order
    valid = spos < T
    picks = jnp.take_along_axis(
        idx, jnp.minimum(spos, T - 1), axis=-1
    )
    return jnp.where(valid, picks, -1), valid


def _weighted_gumbel_dedup(
    key: jax.Array,
    deg: jnp.ndarray,
    off,
    graph: CSRGraph,
    fanout: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted khop WITHOUT replacement — hash-dedup sampler analog
    (cuda_sampling_weighted_khop_hash_dedup.cu).

    The reference draws alias picks per vertex, rejecting already-picked
    neighbor ids until `fanout` UNIQUE neighbors are selected (i.e.
    weighted sampling without replacement); vertices with deg <= fanout
    take all neighbors (lines 85-95). Static-shape mapping, per degree
    regime:

      deg <= fanout          : take every slot once.
      fanout < deg <= 128    : EXACT without-replacement via Gumbel
                               top-k over the vertex's weights
                               (log w_j + Gumbel_j, keep top `fanout` —
                               Efraimidis-Spirakis), with w_j recovered
                               as diffs of the per-vertex cumulative
                               prob_prefix_table fetched as two aligned
                               128-lane rows. No rejection loop.
      deg > 128              : ROUNDS*fanout alias draws, first-fanout-
                               distinct kept (exact conditional on the
                               stream holding >= fanout distinct slots;
                               shortfall rows keep fewer edges).

    Dedup is on the CSR slot, equal to neighbor-id dedup on simple
    graphs (the reference dedups ids; a multigraph with repeated ids in
    one adjacency list would differ).
    """
    n = deg.shape[0]
    prefix = graph.prob_prefix_table
    assert prefix is not None, (
        "weighted_khop_hash_dedup needs prob_prefix_table on the graph"
    )
    k_g, k_s = jax.random.split(key)

    # --- small branch: all slots ---------------------------------------
    col = jax.lax.broadcasted_iota(jnp.int32, (n, fanout), 1)
    small_picks = jnp.where(col < deg[:, None], col, -1)

    # --- Gumbel branch (fanout < deg <= 128): exact --------------------
    G = _GUMBEL_MAX_DEG
    assert prefix.shape[0] % INDICES_LANE == 0, "prefix table not lane-padded"
    rows = prefix.reshape(-1, INDICES_LANE)
    r0 = jnp.clip(
        (off // INDICES_LANE).astype(jnp.int32), 0, rows.shape[0] - 2
    )
    two = jnp.take(
        rows, r0[:, None] + jnp.arange(2, dtype=jnp.int32)[None, :], axis=0
    ).reshape(n, 2 * INDICES_LANE)
    s = (off - r0.astype(off.dtype) * INDICES_LANE).astype(jnp.int32)
    wcol = jax.lax.broadcasted_iota(jnp.int32, (n, G), 1)
    win = jnp.take_along_axis(
        two, jnp.minimum(s[:, None] + wcol, 2 * INDICES_LANE - 1), axis=1
    )                                                        # prefix[off+j]
    w = jnp.concatenate([win[:, :1], win[:, 1:] - win[:, :-1]], axis=1)
    in_deg = wcol < jnp.minimum(deg, G)[:, None]
    gumbel = -jnp.log(-jnp.log(
        jnp.clip(jax.random.uniform(k_g, (n, G)), 1e-20, 1.0)
    ))
    score = jnp.where(
        in_deg, jnp.log(jnp.clip(w, 1e-20, None)) + gumbel, -jnp.inf
    )
    _, gumbel_picks = jax.lax.top_k(score, fanout)
    gumbel_picks = gumbel_picks.astype(jnp.int32)

    # --- stream branch (deg > 128): oversample + first-k-distinct ------
    T = HASHDEDUP_ROUNDS * fanout
    draws, _ = _weighted_alias(k_s, deg, off, graph, T)
    stream_picks, stream_ok = _first_k_distinct(draws, fanout)

    big = deg[:, None] > fanout
    huge = deg[:, None] > G
    picks = jnp.where(
        huge, stream_picks, jnp.where(big, gumbel_picks, small_picks)
    )
    valid = jnp.where(
        huge,
        stream_ok,
        jnp.where(big, jnp.ones_like(stream_ok), col < deg[:, None]),
    )
    return jnp.where(valid, picks, -1), valid


# row width for blocked 1D gathers from the CSR indices array: instead of
# one element gather per edge slot, gather an aligned row of this many
# entries and select the wanted one. Narrower rows cut the [M, LANE]
# intermediate traffic, wider rows cut the number of rows fetched. The
# value has not been swept on a GPU yet. Engines pad `indices` to a
# multiple of this.
INDICES_LANE = int(_os.environ.get("FGNN_TPU_INDICES_LANE", "128"))


def take_1d_blocked(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for 1D int32 `table` via row-gather + lane select.

    Falls back to plain take when the table length is not lane-aligned
    (engines pad; ad-hoc callers may not)."""
    n = table.shape[0]
    if n % INDICES_LANE != 0:
        return jnp.take(table, idx, mode="clip")
    rows = table.reshape(-1, INDICES_LANE)
    rid = jnp.clip(idx // INDICES_LANE, 0, rows.shape[0] - 1)
    off = (idx % INDICES_LANE).astype(jnp.int32)
    g = jnp.take(rows, rid, axis=0)                       # [M, LANE]
    lane = jax.lax.broadcasted_iota(jnp.int32, g.shape, 1)
    return jnp.sum(
        jnp.where(lane == off[:, None], g, 0), axis=1
    ).astype(table.dtype)


# Region-row table fetch: gather each frontier vertex's REGION_ROWS
# aligned 128-lane rows of a per-edge table (covers any deg whose CSR
# range spans <= REGION_ROWS rows; deg <= 129 always spans <= 2) and
# lane-select picks; vertices with wider ranges are compacted
# into HCAP slots with one row fetch per pick. Cuts hop CSR row fetches
# from E (one per edge slot, ~2.1M at fanout 25) to
# ~REGION_ROWS*V + HCAP*F (~0.4M). Exact same sampling distribution —
# only the fetch mechanism changes. A frontier with more than HCAP
# wide-range vertices clips the extras and raises the overflow flag (the
# sampler-cap contract, ops/padding.py) instead of a lax.cond fallback.
# Opt-in: the [V, F, LANE] lane-select broadcast can cost more than the
# saved row fetches; not yet measured on a GPU.
REGION_FETCH = _os.environ.get("FGNN_TPU_REGION_FETCH", "0") not in (
    "", "0", "false"
)
REGION_ROWS = 3
HIGH_DEG_FRAC = int(_os.environ.get("FGNN_TPU_HIGH_DEG_FRAC", "8"))


def _region_select(
    table: jnp.ndarray,         # [E] lane-aligned 1-D per-edge table
    off: jnp.ndarray,           # [V] int (indptr[v])
    deg: jnp.ndarray,           # [V] int32
    idx: jnp.ndarray,           # [V, F] int32 in-range picks (or <0 invalid)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """table[off[v] + idx[v, j]] via region rows + high-degree slots.

    Returns ``(vals [V,F], ok [V] bool, ovf scalar bool)``. ``ok`` is
    False for high-degree vertices beyond the HCAP compaction slots (their
    picks must be masked invalid); ``ovf`` flags that clip.
    """
    LANE = INDICES_LANE
    V, F = idx.shape
    rows = table.reshape(-1, LANE)
    n_rows = rows.shape[0]
    r0 = (off // LANE).astype(jnp.int32)

    # does [off, off+deg) fit in REGION_ROWS aligned rows?
    last_row = ((off + jnp.maximum(deg, 1) - 1) // LANE).astype(jnp.int32)
    span = last_row - r0 + 1
    low = span <= REGION_ROWS

    # --- low-degree: REGION_ROWS region rows per vertex ----------------
    row_ids = jnp.clip(
        r0[:, None]
        + jax.lax.broadcasted_iota(jnp.int32, (V, REGION_ROWS), 1),
        0, n_rows - 1,
    )
    region = jnp.take(rows, row_ids.reshape(-1), axis=0).reshape(
        V, REGION_ROWS, LANE
    )
    flat = off[:, None] + jnp.maximum(idx, 0).astype(off.dtype)  # [V, F]
    rel_row = (flat // LANE).astype(jnp.int32) - r0[:, None]     # [V, F]
    lane = (flat % LANE).astype(jnp.int32)
    # select region[v, rel_row[v,j], lane[v,j]]: per region row, a fused
    # broadcast-compare-reduce lane select (same pattern as
    # take_1d_blocked, which XLA fuses without materializing [V,F,LANE]),
    # then a REGION_ROWS-way where on the row index
    lane_iota = jax.lax.broadcasted_iota(jnp.int32, (V, F, LANE), 2)
    lane_onehot = lane_iota == lane[:, :, None]
    low_vals = jnp.zeros((V, F), dtype=table.dtype)
    for r in range(REGION_ROWS):
        v_r = jnp.sum(
            jnp.where(lane_onehot, region[:, r, :][:, None, :], 0), axis=2
        )
        low_vals = jnp.where(rel_row == r, v_r, low_vals)

    # --- high-degree: gather-compact into HCAP slots -------------------
    # (searchsorted + gathers, not a scatter-based compaction)
    HCAP = max(V // HIGH_DEG_FRAC, 8)
    high = ~low
    csum = jnp.cumsum(high.astype(jnp.int32))      # [V]: #high in [0..v]
    ovf = csum[-1] > HCAP
    # v_of_slot[s] = index of the (s+1)-th high vertex (== V if none)
    v_of_slot = jnp.searchsorted(
        csum, jnp.arange(1, HCAP + 1, dtype=csum.dtype), side="left"
    )
    v_safe = jnp.clip(v_of_slot, 0, V - 1)
    flat_h = jnp.take(flat, v_safe, axis=0)        # [HCAP, F]
    row_h = jnp.clip((flat_h // LANE).astype(jnp.int32), 0, n_rows - 1)
    lane_h = (flat_h % LANE).astype(jnp.int32)
    rows_h = jnp.take(rows, row_h.reshape(-1), axis=0).reshape(
        HCAP, F, LANE
    )
    lane_iota_h = jax.lax.broadcasted_iota(jnp.int32, (HCAP, F, LANE), 2)
    high_vals_slots = jnp.sum(
        jnp.where(lane_iota_h == lane_h[:, :, None], rows_h, 0), axis=2
    )                                              # [HCAP, F]
    # route back: high vertex v reads its slot row
    slot = csum - 1
    slot_c = jnp.clip(slot, 0, HCAP - 1)
    high_vals = jnp.take(high_vals_slots, slot_c, axis=0)        # [V, F]

    ok = low | (slot < HCAP)
    out = jnp.where(low[:, None], low_vals, high_vals)
    return out, ok, ovf


def sample_layer(
    key: jax.Array,
    graph: CSRGraph,
    inputs: jnp.ndarray,
    fanout: int,
    sample_type: SampleType,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sample one hop.

    Args:
      inputs: [N_cap] int32 seed ids, -1 padded.
    Returns:
      (neighbors [N_cap*fanout] int32 -1-padded — slot i*fanout+j is the
       j-th pick of seed i; valid mask [N_cap*fanout] bool;
       ovf scalar bool — region-fetch high-degree slots clipped.)
    """
    n = inputs.shape[0]
    node_ok = inputs >= 0
    safe_in = jnp.where(node_ok, inputs, 0)
    ptr_dtype = graph.indptr.dtype
    off = graph.indptr[safe_in]
    deg = (graph.indptr[safe_in + 1] - off).astype(jnp.int32)
    deg = jnp.where(node_ok, deg, 0)

    if sample_type in (SampleType.KHOP0, SampleType.KHOP2):
        idx, valid = _floyd_without_replacement(key, deg, fanout)
    elif sample_type == SampleType.KHOP1:
        idx, valid = _with_replacement(key, deg, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP:
        idx, valid = _weighted_alias(key, deg, off, graph, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP_HASH_DEDUP:
        idx, valid = _weighted_gumbel_dedup(key, deg, off, graph, fanout)
    elif sample_type == SampleType.WEIGHTED_KHOP_PREFIX:
        idx, valid = _weighted_prefix(key, deg, off, graph, fanout)
    else:
        raise ValueError(f"sample_layer does not handle {sample_type}")

    ovf = jnp.zeros((), bool)
    if REGION_FETCH and graph.indices.shape[0] % INDICES_LANE == 0:
        vals, ok, ovf = _region_select(graph.indices, off, deg, idx)
        nbr = vals.reshape(-1)
        valid = valid & ok[:, None]
    else:
        flat = off[:, None] + jnp.maximum(idx, 0).astype(ptr_dtype)
        flat = jnp.clip(flat, 0, graph.indices.shape[0] - 1)
        nbr = take_1d_blocked(graph.indices, flat.reshape(-1))
    valid = valid.reshape(-1) & jnp.repeat(node_ok, fanout)
    return jnp.where(valid, nbr, -1), valid, ovf


def _tiered_last_hop(
    key: jax.Array,
    graph: CSRGraph,
    cur: jnp.ndarray,
    num_cur: jnp.ndarray,
    tier_layout,
    with_out_degrees: bool,
):
    """Degree-tiered no-dedup last hop (uniform without replacement only).

    The flat ``V * fanout`` edge cap of the last hop is ~33%-occupied at
    bench shapes (E[min(deg, fanout)] << fanout on skewed graphs), and
    the CSR neighbor fetch and the feature gather pay for every PADDED
    slot. ``tier_layout`` = ((cap_0, w_0), (cap_1, w_1), ...), caps
    summing to the frontier cap, widths strictly descending: tier 0
    Floyd-samples at the full fanout w_0; every lower tier holds
    vertices with deg <= its width and takes ALL their neighbors — an
    identical sampling distribution (uniform-without-replacement at
    fanout >= deg IS take-all). Calibrated slot count is ~0.4-0.6x of
    the flat cap (make_plan's tier search).

    Returns ``(block, unique, num_unique, ovf)``. ``ovf`` flags any
    tier-prefix cap exceeded (clipped vertices fall into a narrower
    take-all tier and emit their first `width` neighbors — surfaced
    exactly like every other cap overflow; calibration sizes every
    prefix with max-plus-range margin).
    """
    V = cur.shape[0]
    caps = [c for c, _ in tier_layout]
    widths = [w for _, w in tier_layout]
    assert sum(caps) == V, (caps, V)
    node_ok = cur >= 0
    safe_in = jnp.where(node_ok, cur, 0)
    ptr_dtype = graph.indptr.dtype
    off = graph.indptr[safe_in]
    deg = (graph.indptr[safe_in + 1] - off).astype(jnp.int32)
    deg = jnp.where(node_ok, deg, 0)

    # tier class: 0 for deg > widths[1], else the narrowest take-all
    # tier whose width covers deg (padding: deg 0 -> last tier, where it
    # yields zero valid picks)
    c = jnp.zeros((V,), jnp.int32)
    for t in widths[1:]:
        c = c + (deg <= t).astype(jnp.int32)

    # stable partition by (class, position): ONE multi-operand sort
    # carries order, deg, and off — separate take(x, order) permutes are
    # 80K ELEMENT-gathers each (the slow primitive take_1d_blocked
    # exists to avoid).
    iota_v = jax.lax.iota(jnp.int32, V)
    _, order, deg_p, off_p = jax.lax.sort(
        (c, iota_v, deg, off), num_keys=2,
    )
    inv = jax.lax.sort((order, iota_v), num_keys=1)[1]

    # any tier-prefix cap exceeded? (class <= j count vs prefix cap)
    ovf = jnp.zeros((), bool)
    pref = 0
    for j in range(len(caps) - 1):
        pref += caps[j]
        ovf = ovf | (jnp.sum(c <= j) > pref)

    E_idx = graph.indices.shape[0] - 1
    nbrs, valids, dsts = [], [], []
    pos = 0
    for i, (cap_i, w_i) in enumerate(zip(caps, widths)):
        deg_i = jax.lax.slice_in_dim(deg_p, pos, pos + cap_i)
        off_i = jax.lax.slice_in_dim(off_p, pos, pos + cap_i)
        if i == 0:
            # Floyd at full fanout (deg <= w rows degrade to take-all)
            idx_i, valid_i = _floyd_without_replacement(key, deg_i, w_i)
            flat = off_i[:, None] + jnp.maximum(idx_i, 0).astype(ptr_dtype)
        else:
            col = jax.lax.broadcasted_iota(jnp.int32, (cap_i, w_i), 1)
            valid_i = col < jnp.minimum(deg_i, w_i)[:, None]
            flat = off_i[:, None] + col.astype(ptr_dtype)
        flat = jnp.clip(flat, 0, E_idx)
        nbrs.append(take_1d_blocked(graph.indices, flat.reshape(-1)))
        valids.append(valid_i.reshape(-1))
        dsts.append(jnp.broadcast_to(
            jax.lax.slice_in_dim(order, pos, pos + cap_i)[:, None],
            (cap_i, w_i),
        ).reshape(-1))
        pos += cap_i

    valid = jnp.concatenate(valids)
    nbr = jnp.concatenate(nbrs)
    E = sum(cp * w for cp, w in tier_layout)
    slot = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0).squeeze(-1)
    src_local = jnp.where(valid, V + slot, -1)
    dst_local = jnp.where(valid, jnp.concatenate(dsts), -1)
    unique = jnp.concatenate([cur, jnp.where(valid, nbr, -1)])
    num_unique = num_cur + jnp.sum(valid).astype(jnp.int32)
    counts = None
    if with_out_degrees:
        counts = jnp.concatenate(
            [jnp.zeros((V,), jnp.int32), valid.astype(jnp.int32)]
        )
    blk = Block(
        src_local=src_local,
        dst_local=dst_local,
        mask=valid,
        num_src=num_unique.astype(jnp.int32),
        num_dst=num_cur.astype(jnp.int32),
        src_out_deg=counts,
        slots_per_dst=None,
        src_slice_offset=V,
        tier_split=tuple(tier_layout),
        dst_invperm=inv,
    )
    return blk, unique, num_unique, ovf


# ---------------------------------------------------------------------------
# multi-layer pipeline (DoGPUSample analog, cuda_loops.cc:50-267)
# ---------------------------------------------------------------------------

def multi_layer_sample(
    key: jax.Array,
    graph: CSRGraph,
    seeds: jnp.ndarray,
    num_seeds: jnp.ndarray,
    plan: SamplePlan,
    sample_type: SampleType,
    dedup_last_hop: bool = True,
    with_out_degrees: bool = False,
) -> SampledBatch:
    """Sample all hops + dedup + local-id remap, fully jittable.

    ``with_out_degrees=True`` attaches per-local src out-degree counts to
    every block (``Block.src_out_deg``), emitted by the dedup sort itself
    — GCN's norm='both' consumes them instead of scatter-adding over the
    edge stream (models/aggregate.py::out_degrees).

    Mirrors the reference inner loop (cuda_loops.cc:87-257): per hop,
    sample -> FillWithDuplicates -> MapEdges; the final unique list is the
    batch's ``input_nodes`` for feature extraction.

    ``dedup_last_hop=False`` is a fast mode for device-resident
    features: the deepest hop skips dedup entirely — ``input_nodes``
    becomes ``[frontier | sampled neighbors]`` (with duplicates) and each
    edge's src_local points at its own slot (S + edge_index), so the
    model's per-edge source gather degenerates to a SLICE. It trades the
    dedup sort + local-id unscatter over ~2M edges for duplicate
    feature-row reads; dedup pays off when features are host-resident
    (cache mode), where every row read crosses the host link.
    """
    assert seeds.shape[0] == plan.num_input_cap[0], (
        f"seeds cap {seeds.shape[0]} != plan {plan.num_input_cap[0]}"
    )
    cur = seeds
    num_cur = num_seeds
    blocks_rev: List[Block] = []
    overflowed = jnp.zeros((), dtype=bool)

    for hop in range(plan.num_layer):
        fanout = plan.fanouts[hop]
        last = hop == plan.num_layer - 1
        k = jax.random.fold_in(key, hop)

        if (
            last
            and not dedup_last_hop
            and plan.tier_layout is not None
            and sample_type in (SampleType.KHOP0, SampleType.KHOP2)
        ):
            # degree-tiered fast path (uniform-without-replacement only:
            # take-all on the narrow tiers is distribution-identical
            # there, but NOT for with-replacement/weighted samplers)
            blk, unique, num_unique, t_ovf = _tiered_last_hop(
                k, graph, cur, num_cur, plan.tier_layout,
                with_out_degrees,
            )
            overflowed = overflowed | t_ovf
            blocks_rev.append(blk)
            cur = unique
            num_cur = num_unique
            continue

        nbrs, valid, fetch_ovf = sample_layer(
            k, graph, cur, fanout, sample_type
        )
        overflowed = overflowed | fetch_ovf

        counts = None
        if last and not dedup_last_hop:
            S = cur.shape[0]
            E = nbrs.shape[0]
            # src slot j holds neighbor j itself, appended after the
            # frontier: gather_src(h)[j] == h[S + j]
            src_local = jnp.where(
                valid,
                S + jax.lax.broadcasted_iota(
                    jnp.int32, (E, 1), 0
                ).squeeze(-1),
                -1,
            )
            unique = jnp.concatenate([cur, jnp.where(valid, nbrs, -1)])
            num_unique = (
                num_cur + jnp.sum(valid).astype(jnp.int32)
            )
            ovf = jnp.zeros((), bool)
            if with_out_degrees:
                # each appended slot is its own src, used by exactly its
                # own edge; frontier entries are never a src here
                counts = jnp.concatenate(
                    [jnp.zeros((S,), jnp.int32), valid.astype(jnp.int32)]
                )
        elif with_out_degrees:
            # counts ride the dedup sort — sort path only (the direct
            # path would need the [num_node]-table scatter-add this
            # feature exists to avoid)
            unique, num_unique, src_local, ovf, counts = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop],
                with_counts=True,
            )
        elif graph.num_node <= DIRECT_REMAP_MAX_NODES:
            unique, num_unique, src_local, ovf = unique_and_remap_direct(
                cur, num_cur, nbrs, plan.num_unique_cap[hop], graph.num_node
            )
        else:
            unique, num_unique, src_local, ovf = unique_and_remap(
                cur, num_cur, nbrs, plan.num_unique_cap[hop]
            )
        overflowed = overflowed | ovf

        # lazy iota, NOT jnp.repeat(arange(...)) — a concrete repeat bakes a
        # multi-MB constant into the executable and wrecks compile time
        dst_local = jax.lax.broadcasted_iota(
            jnp.int32, (plan.num_input_cap[hop], fanout), 0
        ).reshape(-1)
        mask = valid & (src_local >= 0)
        blocks_rev.append(
            Block(
                src_local=jnp.where(mask, src_local, -1),
                dst_local=jnp.where(mask, dst_local, -1),
                mask=mask,
                num_src=num_unique.astype(jnp.int32),
                num_dst=num_cur.astype(jnp.int32),
                src_out_deg=counts,
                slots_per_dst=fanout,
                src_slice_offset=(
                    cur.shape[0] if (last and not dedup_last_hop) else None
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
