"""Mask-aware message-passing primitives over padded COO blocks.

These replace DGL's ``update_all(fn.u_mul_e/copy_u, fn.sum/mean)`` message
passing used by the reference models (example/samgraph/multi_gpu/train_*.py)
with mask-aware aggregation: a dense reshape+reduce for REGULAR blocks
(fixed slots per destination), `jax.ops.segment_sum` otherwise. Padded
edges scatter into a trash row that is sliced off, so no branching on
dynamic edge counts is needed. On a GPU, segment_sum lowers to an atomic
scatter-add, whose summation order is not fixed.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.sampling import Block


def gather_src(h_src: jnp.ndarray, block: Block) -> jnp.ndarray:
    """Per-edge source features [E_cap, D]; padded edges read junk rows,
    masked later by the aggregation's `where(mask, ...)`."""
    if block.src_slice_offset is not None:
        # no-dedup layout: slot j's src row IS h[offset + j] — a static
        # slice instead of an E_cap-row gather (see Block.src_slice_offset)
        off = block.src_slice_offset
        return jax.lax.slice_in_dim(
            h_src, off, off + block.src_local.shape[0], axis=0
        )
    idx = jnp.maximum(block.src_local, 0)
    return jnp.take(h_src, idx, axis=0)


def segment_agg(
    messages: jnp.ndarray,
    block: Block,
    dst_cap: int,
    *,
    mode: str = "sum",
    edge_weights: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Aggregate per-edge messages into destination rows.

    Args:
      messages: [E_cap, D] per-edge payload (already gathered from src).
      mode: 'sum' | 'mean' | 'weighted_mean'.
    Returns: [dst_cap, D].
    """
    mask = block.mask
    K = block.slots_per_dst
    if K is not None and mask.shape[0] == dst_cap * K:
        # REGULAR block: dst d owns slots [d*K, (d+1)*K) — aggregation is
        # a dense reshape+reduce with a fixed summation order, no scatter
        D = messages.shape[-1]
        m = mask.reshape(dst_cap, K)
        if mode == "weighted_mean":
            assert edge_weights is not None
            w = jnp.where(m, edge_weights.reshape(dst_cap, K), 0.0)
            msg = messages.reshape(dst_cap, K, D) * w[..., None]
            agg = msg.sum(axis=1)
            return agg / jnp.maximum(w.sum(axis=1), 1.0)[:, None]
        msg = jnp.where(
            m[..., None], messages.reshape(dst_cap, K, D), 0.0
        )
        agg = msg.sum(axis=1)
        if mode == "mean":
            cnt = m.sum(axis=1).astype(messages.dtype)
            agg = agg / jnp.maximum(cnt, 1.0)[:, None]
        return agg

    ts = block.tier_split
    if ts is not None and mask.shape[0] == sum(v * k for v, k in ts):
        # TIERED block (Block.tier_split, ((cap, width), ...)): per-tier
        # dense reshape+reduce in tier order, then ONE [V]-row gather
        # (dst_invperm) restores original dst order — still no scatter.
        assert dst_cap == sum(v for v, _ in ts), (dst_cap, ts)
        D = messages.shape[-1]
        sums, dens = [], []
        lo = 0
        for v, k in ts:
            m = jax.lax.slice_in_dim(mask, lo, lo + v * k).reshape(v, k)
            msg = jax.lax.slice_in_dim(
                messages, lo, lo + v * k
            ).reshape(v, k, D)
            if mode == "weighted_mean":
                assert edge_weights is not None
                w = jnp.where(
                    m,
                    jax.lax.slice_in_dim(
                        edge_weights, lo, lo + v * k
                    ).reshape(v, k),
                    0.0,
                )
                sums.append((msg * w[..., None]).sum(axis=1))
                dens.append(w.sum(axis=1))
            else:
                sums.append(jnp.where(m[..., None], msg, 0.0).sum(axis=1))
                dens.append(m.sum(axis=1).astype(messages.dtype))
            lo += v * k
        agg = jnp.concatenate(sums, axis=0)
        if mode in ("mean", "weighted_mean"):
            den = jnp.concatenate(dens, axis=0)
            agg = agg / jnp.maximum(den, 1.0)[:, None]
        return jnp.take(agg, block.dst_invperm, axis=0)

    dst = jnp.where(mask, block.dst_local, dst_cap)  # trash row = dst_cap
    w = None
    if mode == "weighted_mean":
        assert edge_weights is not None
        w = jnp.where(mask, edge_weights, 0.0)
        messages = messages * w[:, None]
    else:
        messages = jnp.where(mask[:, None], messages, 0.0)

    agg = jax.ops.segment_sum(messages, dst, num_segments=dst_cap + 1)[:dst_cap]

    if mode == "mean":
        cnt = jax.ops.segment_sum(
            mask.astype(messages.dtype), dst, num_segments=dst_cap + 1
        )[:dst_cap]
        agg = agg / jnp.maximum(cnt, 1.0)[:, None]
    elif mode == "weighted_mean":
        ws = jax.ops.segment_sum(w, dst, num_segments=dst_cap + 1)[:dst_cap]
        agg = agg / jnp.maximum(ws, 1.0)[:, None]
    return agg


def segment_softmax(
    scores: jnp.ndarray, block: Block, dst_cap: int
) -> jnp.ndarray:
    """Edge-softmax over incoming edges of each dst (GAT attention).

    scores: [E_cap, H]; returns normalized [E_cap, H] (0 on padded edges).
    """
    mask = block.mask
    K = block.slots_per_dst
    neg_inf = jnp.finfo(scores.dtype).min
    if K is not None and mask.shape[0] == dst_cap * K:
        H = scores.shape[-1]
        m = mask.reshape(dst_cap, K, 1)
        s = jnp.where(m, scores.reshape(dst_cap, K, H), neg_inf)
        smax = jnp.max(s, axis=1, keepdims=True)
        smax = jnp.where(smax == neg_inf, 0.0, smax)
        ex = jnp.where(m, jnp.exp(s - smax), 0.0)
        denom = jnp.maximum(ex.sum(axis=1, keepdims=True), 1e-16)
        return (ex / denom).reshape(dst_cap * K, H)

    ts = block.tier_split
    if ts is not None and mask.shape[0] == sum(v * k for v, k in ts):
        # TIERED block: per-tier softmax; edge layout preserved (each dst
        # owns one contiguous slot run inside its tier), no unperm needed
        H = scores.shape[-1]
        outs = []
        lo = 0
        for v, k in ts:
            m = jax.lax.slice_in_dim(mask, lo, lo + v * k).reshape(v, k, 1)
            s = jnp.where(
                m,
                jax.lax.slice_in_dim(scores, lo, lo + v * k).reshape(v, k, H),
                neg_inf,
            )
            smax = jnp.max(s, axis=1, keepdims=True)
            smax = jnp.where(smax == neg_inf, 0.0, smax)
            ex = jnp.where(m, jnp.exp(s - smax), 0.0)
            denom = jnp.maximum(ex.sum(axis=1, keepdims=True), 1e-16)
            outs.append((ex / denom).reshape(v * k, H))
            lo += v * k
        return jnp.concatenate(outs, axis=0)

    dst = jnp.where(mask, block.dst_local, dst_cap)
    masked = jnp.where(mask[:, None], scores, neg_inf)
    smax = jax.ops.segment_max(masked, dst, num_segments=dst_cap + 1)
    smax = jnp.where(smax == neg_inf, 0.0, smax)
    ex = jnp.exp(masked - smax[dst])
    ex = jnp.where(mask[:, None], ex, 0.0)
    denom = jax.ops.segment_sum(ex, dst, num_segments=dst_cap + 1)
    return ex / jnp.maximum(denom[dst], 1e-16)


def in_degrees(block: Block, dst_cap: int) -> jnp.ndarray:
    mask = block.mask
    K = block.slots_per_dst
    if K is not None and mask.shape[0] == dst_cap * K:
        return mask.reshape(dst_cap, K).sum(axis=1).astype(jnp.float32)
    ts = block.tier_split
    if ts is not None and mask.shape[0] == sum(v * k for v, k in ts):
        parts = []
        lo = 0
        for v, k in ts:
            parts.append(
                jax.lax.slice_in_dim(mask, lo, lo + v * k)
                .reshape(v, k).sum(axis=1)
            )
            lo += v * k
        cnt = jnp.concatenate(parts).astype(jnp.float32)
        return jnp.take(cnt, block.dst_invperm)
    dst = jnp.where(mask, block.dst_local, dst_cap)
    return jax.ops.segment_sum(
        mask.astype(jnp.float32), dst, num_segments=dst_cap + 1
    )[:dst_cap]


def out_degrees(block: Block, src_cap: int) -> jnp.ndarray:
    if block.src_out_deg is not None:
        # emitted by the dedup sort (ops/hashtable.py::unique_and_remap
        # with_counts) — no scatter needed
        return block.src_out_deg[:src_cap].astype(jnp.float32)
    mask = block.mask
    src = jnp.where(mask, block.src_local, src_cap)
    return jax.ops.segment_sum(
        mask.astype(jnp.float32), src, num_segments=src_cap + 1
    )[:src_cap]
