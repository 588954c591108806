"""Pure-NumPy references: sampler, cap calibration, conv-layer goldens.

Golden model for tests (SURVEY.md §4 implication: golden numerics vs a
pure-NumPy reference) and the cap-calibration oracle: the engine runs a few
NumPy sampling steps to measure realistic per-hop unique/edge counts, which
bound the static padded shapes (SamplePlan) far below the multiplicative
worst case — the measured analog of PredictNumNodes (common.h:244-250).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def np_sample_hop(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanout: int,
    replace: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (src_global, dst_global) edge lists (variable length)."""
    srcs, dsts = [], []
    for v in seeds:
        off, end = int(indptr[v]), int(indptr[v + 1])
        deg = end - off
        if deg == 0:
            continue
        if replace:
            picks = rng.integers(0, deg, size=fanout)
        elif deg <= fanout:
            picks = np.arange(deg)
        else:
            picks = rng.choice(deg, size=fanout, replace=False)
        nb = indices[off + picks]
        srcs.append(nb)
        dsts.append(np.full(len(nb), v, dtype=np.int64))
    if not srcs:
        return np.array([], np.int64), np.array([], np.int64)
    return np.concatenate(srcs), np.concatenate(dsts)


def np_multi_layer_counts(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    replace: bool = False,
) -> Tuple[List[int], List[int]]:
    """Per-hop (num_unique, num_edge) for cap calibration.

    ``fanouts`` already in sampling order (seed hop first).
    """
    cur = np.unique(seeds)
    uniq_counts, edge_counts = [], []
    for f in fanouts:
        src, dst = np_sample_hop(rng, indptr, indices, cur, f, replace)
        uniq = np.union1d(cur, src)
        uniq_counts.append(len(uniq))
        edge_counts.append(len(src))
        cur = uniq
    return uniq_counts, edge_counts


def np_sample_hop_vec(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanout: int,
    replace: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized hop sampler (cpu_sampling_khop*.cc analog).

    seeds: [n] valid node ids. Returns (nbr [n, fanout] int32 -1-padded,
    valid mask [n, fanout]). Distribution matches the jax samplers
    (uniform with/without replacement).
    """
    n = len(seeds)
    off = indptr[seeds]
    deg = (indptr[seeds + 1] - off).astype(np.int64)
    if replace:
        u = rng.random((n, fanout))
        idx = np.minimum((u * deg[:, None]).astype(np.int64), deg[:, None] - 1)
        valid = np.broadcast_to((deg > 0)[:, None], idx.shape)
    else:
        # vectorized Floyd (mirrors ops.sampling._floyd_without_replacement)
        u = rng.random((n, fanout))
        idx = np.full((n, fanout), -1, dtype=np.int64)
        big = deg >= fanout
        for j in range(fanout):
            J = deg - fanout + j
            t = np.minimum((u[:, j] * (J + 1)).astype(np.int64), J)
            if j > 0:
                coll = (idx[:, :j] == t[:, None]).any(axis=1)
                t = np.where(coll, J, t)
            small = np.where(j < deg, j, -1)
            idx[:, j] = np.where(big, t, small)
        valid = idx >= 0
    flat = off[:, None] + np.maximum(idx, 0)
    nbr = indices[np.minimum(flat, len(indices) - 1)].astype(np.int32)
    return np.where(valid, nbr, -1), valid


def calibrate_caps(
    indptr: np.ndarray,
    indices: np.ndarray,
    train_set: np.ndarray,
    batch_size: int,
    fanouts_sampling_order: Sequence[int],
    num_probe: int = 8,
    seed: int = 0,
    replace: bool = False,
    tier_candidates: "Optional[Sequence[int]]" = None,
) -> "List[Tuple[int, int]]":
    """Per-hop unique-count caps from random probe batches.

    PredictNumNodes analog (reference common.h:244-250), but measured
    rather than worst-case. Cap = max over probes PLUS the observed
    probe-to-probe range as headroom: a few probes estimate the location
    of the epoch maximum but not its tail, and an under-cap silently
    clips batches mid-epoch (MULTICHIP_r02 tripped the overflow backstop
    with 2 plain-max probes). The range margin scales with the config's
    actual batch variance — skewed graphs get real headroom, regular
    graphs pay nothing — and the engine's ALLOC_SCALE (1.25x, the
    reference's allocation scale, constant.h:78) still applies on top.

    Returns one ``(cumulative, new)`` pair per hop: the cumulative unique
    count and the NEW-nodes-appended count, both max-plus-range. The plan
    sizes each hop's unique buffer as ``static_seed_block + new`` — the
    buffer layout keeps seeds at their input positions, so the appended
    region is what actually needs capacity (a cumulative cap clamped at
    num_node left ZERO append room once the frontier saturated the graph,
    guaranteeing clipping — fig17a round-4 regression).
    """
    rng = np.random.default_rng(seed)
    num_probe = max(2, num_probe)
    obs = [[] for _ in fanouts_sampling_order]
    obs_new = [[] for _ in fanouts_sampling_order]
    tier_obs = {fB: [] for fB in (tier_candidates or ())}
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    last = len(fanouts_sampling_order) - 1
    for _ in range(num_probe):
        seeds = rng.choice(train_set, size=min(batch_size, len(train_set)),
                           replace=False)
        cur = np.unique(seeds)
        for l, f in enumerate(fanouts_sampling_order):
            if l == last and tier_obs:
                # degree-tier sizing for the last hop: how many frontier
                # vertices exceed each candidate small-tier width
                deg = indptr[cur + 1] - indptr[cur]
                for fB in tier_obs:
                    tier_obs[fB].append(int((deg > fB).sum()))
            nbr, valid = np_sample_hop_vec(rng, indptr, indices, cur, f,
                                           replace)
            uniq = np.union1d(cur, nbr[valid])
            obs[l].append(len(uniq))
            obs_new[l].append(len(uniq) - len(cur))
            cur = uniq
    caps = []
    for counts, news in zip(obs, obs_new):
        hi, lo = max(counts), min(counts)
        nhi, nlo = max(news), min(news)
        caps.append((hi + (hi - lo), nhi + (nhi - nlo)))
    if tier_candidates is not None:
        return caps, tier_obs
    return caps


# ---------------------------------------------------------------------------
# NumPy conv-layer goldens (edge loops, no shared code with fgnn_tpu.models)
#
# DGL semantics of the reference's models (tests/test_model_golden.py
# lists them); each golden takes a padded Block and the src-space
# features and returns the dst rows.
# ---------------------------------------------------------------------------

def edges_of(block):
    """(src_local, dst_local, weights) of a block's real edges, on the host."""
    m = np.asarray(block.mask)
    return (np.asarray(block.src_local)[m], np.asarray(block.dst_local)[m],
            None if block.weights is None else np.asarray(block.weights)[m])


def golden_graphconv(block, h, dst_cap, W, b):
    src, dst, _ = edges_of(block)
    feat = h @ W
    src_cap = h.shape[0]
    outdeg = np.zeros(src_cap)
    indeg = np.zeros(dst_cap)
    for s, d in zip(src, dst):
        outdeg[s] += 1
        indeg[d] += 1
    feat = feat / np.sqrt(np.maximum(outdeg, 1.0))[:, None]
    rst = np.zeros((dst_cap, W.shape[1]))
    for s, d in zip(src, dst):
        rst[d] += feat[s]
    rst = rst / np.sqrt(np.maximum(indeg, 1.0))[:, None]
    return rst + b


def golden_sageconv(block, h, dst_cap, Ws, bs, Wn):
    src, dst, _ = edges_of(block)
    agg = np.zeros((dst_cap, h.shape[1]))
    cnt = np.zeros(dst_cap)
    for s, d in zip(src, dst):
        agg[d] += h[s]
        cnt[d] += 1
    agg = agg / np.maximum(cnt, 1.0)[:, None]
    return (h[:dst_cap] @ Ws + bs) + agg @ Wn


def golden_weighted_sage(block, h, dst_cap, Q, bQ, W, bW):
    src, dst, w = edges_of(block)
    n = np.maximum(h @ Q + bQ, 0.0)
    agg = np.zeros((dst_cap, n.shape[1]))
    ws = np.zeros(dst_cap)
    for s, d, wi in zip(src, dst, w):
        agg[d] += wi * n[s]
        ws[d] += wi
    agg = agg / np.maximum(ws, 1.0)[:, None]
    z = np.maximum(np.concatenate([agg, h[:dst_cap]], axis=1) @ W + bW, 0.0)
    norm = np.linalg.norm(z, axis=1, keepdims=True)
    norm[norm == 0.0] = 1.0
    return z / norm


def golden_gatconv(block, h, dst_cap, W, attn_l, attn_r, slope=0.2):
    src, dst, _ = edges_of(block)
    H, D = attn_l.shape[1], attn_l.shape[2]
    feat = (h @ W).reshape(-1, H, D)
    el = np.sum(feat * attn_l, axis=-1)   # [src_cap, H]
    er = np.sum(feat * attn_r, axis=-1)
    e = el[src] + er[dst]                 # [E, H]
    e = np.where(e > 0, e, slope * e)     # leaky relu
    out = np.zeros((dst_cap, H, D))
    for d in range(dst_cap):
        sel = dst == d
        if not sel.any():
            continue
        ed = e[sel]                       # [k, H]
        a = np.exp(ed - ed.max(axis=0, keepdims=True))
        a = a / a.sum(axis=0, keepdims=True)
        out[d] = np.einsum("kh,khd->hd", a, feat[src[sel]])
    return out