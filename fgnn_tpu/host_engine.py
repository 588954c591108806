"""Host-sampling engine (arch0 analog).

Reference: CPUEngine (samgraph/common/cpu/cpu_engine.cc) — CPU (OpenMP)
sampling + GPU training in one process. Here: vectorized NumPy sampling +
host dedup/renumber, features gathered host-side (native lib when built),
then one jitted device train step per batch. Useful when the topology does
not fit HBM, and as an independent cross-check of the on-device sampler.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import RunConfig, SampleType
from .data.schema import Dataset
from .models import build_model
from .ops.extract import host_gather
from .ops.padding import make_plan
from .ops.reference_impl import calibrate_caps, np_sample_hop_vec
from .ops.sampling import Block, SampledBatch
from .parallel.shuffler import EpochShuffler
from .train.loop import create_train_state, make_train_step, masked_cross_entropy
from .utils import Timer, get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)


def _np_khop_hop(rng, indptr, indices, cur, f, replace):
    """One uniform khop hop: native threaded sampler
    (cpu_sampling_khop0.cc analog) when the shared object is built;
    NumPy reference otherwise. Returns ([S,f] int32 -1-padded, None)."""
    from . import native

    S = cur.shape[0]
    nat = native.sample_khop(
        indptr, indices, cur[:S], f,
        seed=int(rng.integers(0, 2**62)), replace=replace,
    )
    if nat is not None:
        return nat, None
    valid_in = cur >= 0
    nbr = np.full((S, f), -1, dtype=np.int32)
    if valid_in.any():
        vs = cur[valid_in].astype(np.int64)
        got, gv = np_sample_hop_vec(rng, indptr, indices, vs, f, replace)
        nbr[valid_in] = np.where(gv, got, -1)
    return nbr, None


def _np_weighted_hop(rng, indptr, indices, gcum, cur, f, dedup=False):
    """Weighted hop via inverse-CDF on a GLOBAL weight cumsum
    (cpu_sampling_weighted_khop.cc analog, vectorized).

    ``gcum`` is np.cumsum over ALL edge weights, so a single searchsorted
    of `gcum[off-1] + u*total_v` lands directly on the global edge slot —
    no per-vertex loop. With ``dedup`` the picks are made UNIQUE per
    vertex (reference hash-dedup semantics): vectorized first-f-distinct
    over an oversampled stream, then an exact per-row rejection loop for
    the (rare) short rows.
    """
    from . import native

    nat = native.sample_weighted_khop(
        indptr, indices, gcum, cur, f,
        seed=int(rng.integers(0, 2**62)), dedup=dedup,
    )
    if nat is not None:
        return nat, None
    S = cur.shape[0]
    valid_in = cur >= 0
    safe = np.maximum(cur, 0).astype(np.int64)
    off = np.asarray(indptr)[safe]
    end = np.asarray(indptr)[safe + 1]
    deg = (end - off).astype(np.int64)
    gpad = np.concatenate([[0.0], gcum])
    base = gpad[off]
    tot = gpad[end] - base
    ok = valid_in & (deg > 0)

    def draw(cols):
        u = rng.random((S, cols)) * tot[:, None]
        e = np.searchsorted(gcum, base[:, None] + u, side="left")
        return np.clip(e, off[:, None], (end - 1)[:, None])

    if not dedup:
        e = draw(f)
        nbr = np.where(ok[:, None], indices[e], -1).astype(np.int32)
        return nbr, None

    # --- hash-dedup: fanout UNIQUE picks (take-all when deg <= f) -------
    T = 4 * f
    e = draw(T)
    order = np.argsort(e, axis=1, kind="stable")
    sv = np.take_along_axis(e, order, axis=1)
    first = np.concatenate(
        [np.ones((S, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
    )
    fpos = np.where(first, order, T)
    spos = np.sort(fpos, axis=1)[:, :f]
    picks = np.take_along_axis(e, np.minimum(spos, T - 1), axis=1)
    got = np.where(spos < T, picks, -1)
    want = np.minimum(deg, f)
    # take-all for deg <= f
    small = deg <= f
    if small.any():
        col = np.arange(f)[None, :]
        allp = off[:, None] + col
        got[small] = np.where(col < deg[small, None], allp[small], -1)
    # exact rejection finish for rows still short (reference loop)
    short = ok & ((got >= 0).sum(1) < want)
    for i in np.nonzero(short)[0]:
        have = set(int(x) for x in got[i] if x >= 0)
        while len(have) < int(want[i]):
            u = rng.random() * tot[i]
            x = int(np.clip(np.searchsorted(gcum, base[i] + u), off[i],
                            end[i] - 1))
            have.add(x)
        got[i] = list(have)[:f] + [-1] * (f - len(have))
    nbr = np.where(ok[:, None] & (got >= 0), indices[np.maximum(got, 0)],
                   -1).astype(np.int32)
    return nbr, None


def _np_random_walk_hop(rng, indptr, indices, cur, K, W, L, restart):
    """PinSAGE hop: W walks of length L per vertex, early-terminated with
    ``restart`` prob, then per-row top-K visited by multiplicity
    (cpu_sampling_random_walk.cc + FrequencyHashmap analog). Returns
    ([S,K] neighbors, [S,K] f32 visit-count weights)."""
    from . import native

    nat = native.sample_random_walk(
        indptr, indices, cur, W, L, restart, K,
        seed=int(rng.integers(0, 2**62)),
    )
    if nat is not None:
        return nat
    S = cur.shape[0]
    node = np.broadcast_to(cur[:, None], (S, W)).astype(np.int32).copy()
    visits = np.full((S, W, L), -1, dtype=np.int32)
    E = len(indices)
    for step in range(L):
        alive = node >= 0
        safe = np.maximum(node, 0).astype(np.int64)
        off = np.asarray(indptr)[safe]
        deg = (np.asarray(indptr)[safe + 1] - off).astype(np.int64)
        pick = np.minimum((rng.random((S, W)) * deg).astype(np.int64),
                          np.maximum(deg - 1, 0))
        nxt = indices[np.clip(off + pick, 0, E - 1)]
        okw = alive & (deg > 0)
        vis = np.where(okw, nxt, -1).astype(np.int32)
        visits[:, :, step] = vis
        die = rng.random((S, W)) < restart
        node = np.where(okw & ~die, vis, -1)
    flat = visits.reshape(S, W * L)
    M = flat.shape[1]
    eq = flat[:, :, None] == flat[:, None, :]
    valid = flat >= 0
    count = (eq & valid[:, None, :]).sum(axis=2)
    iota = np.arange(M)
    first = ((eq & (iota[None, None, :] < iota[None, :, None])).sum(axis=2)
             == 0)
    score = np.where(valid & first, count, 0)
    k_eff = min(K, M)
    topi = np.argsort(-score, axis=1, kind="stable")[:, :k_eff]
    topv = np.take_along_axis(score, topi, axis=1)
    dst = np.take_along_axis(flat, topi, axis=1)
    okk = topv > 0
    dst = np.where(okk, dst, -1)
    w = np.where(okk, topv.astype(np.float32), 0.0)
    if k_eff < K:
        dst = np.pad(dst, ((0, 0), (0, K - k_eff)), constant_values=-1)
        w = np.pad(w, ((0, 0), (0, K - k_eff)))
    return dst.astype(np.int32), w


def np_multi_layer_sample(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds_pad: np.ndarray,
    num_seeds: int,
    plan,
    replace: bool = False,
    hop_fn=None,
) -> SampledBatch:
    """Host-side DoCPUSample analog producing the same padded Task layout
    as the on-device sampler (cpu_loops.cc:55-192).

    ``hop_fn(rng, cur, f, hop) -> (nbr [S,f], weights [S,f] or None)``
    overrides the per-hop sampler (weighted / random-walk variants);
    default is uniform khop."""
    cur = seeds_pad.copy()
    num_cur = num_seeds
    blocks_rev: List[Block] = []
    for hop in range(plan.num_layer):
        f = plan.fanouts[hop]
        S = plan.num_input_cap[hop]
        cap = plan.num_unique_cap[hop]
        if hop_fn is None:
            nbr, wgt = _np_khop_hop(rng, indptr, indices, cur[:S], f,
                                    replace)
        else:
            nbr, wgt = hop_fn(rng, cur[:S], f, hop)
        nbr_flat = nbr.reshape(-1)

        # dedup: seeds-first + new nodes ascending (hashtable invariant).
        # Native CPUHashTable2-style path when built (O(batch) memory);
        # NumPy dense-table fallback otherwise (O(num_node)/hop — fine at
        # test scale, prohibitive at papers100M).
        from . import native

        nat = native.dedup_remap(cur[:S], nbr_flat, cap)
        if nat is not None:
            unique, n_new, src_local = nat
        else:
            new = np.unique(nbr_flat[nbr_flat >= 0])
            new = new[~np.isin(new, cur[cur >= 0])]
            n_new = min(len(new), cap - S)
            unique = np.full(cap, -1, dtype=np.int32)
            unique[:S] = cur
            unique[S : S + n_new] = new[:n_new]

            # remap via dense table
            table = np.full(int(max(indptr.shape[0], 1)), -1,
                            dtype=np.int32)
            pos = np.nonzero(unique >= 0)[0]
            table[unique[pos]] = pos
            src_local = np.where(
                nbr_flat >= 0, table[np.maximum(nbr_flat, 0)], -1
            )
        dst_local = np.repeat(np.arange(S, dtype=np.int32), f)
        mask = (src_local >= 0) & (nbr_flat >= 0)
        blocks_rev.append(
            Block(
                src_local=jnp.asarray(np.where(mask, src_local, -1)),
                dst_local=jnp.asarray(np.where(mask, dst_local, -1)),
                mask=jnp.asarray(mask),
                num_src=jnp.int32(num_cur + n_new),
                num_dst=jnp.int32(num_cur),
                weights=(
                    jnp.asarray(np.where(mask, wgt.reshape(-1), 0.0))
                    if wgt is not None else None
                ),
                slots_per_dst=f,
            )
        )
        cur = unique
        num_cur = num_cur + n_new

    return SampledBatch(
        blocks=tuple(reversed(blocks_rev)),
        input_nodes=jnp.asarray(cur),
        num_input=jnp.int32(num_cur),
        output_nodes=jnp.asarray(seeds_pad[: plan.batch_size]),
        num_output=jnp.int32(num_seeds),
        overflowed=jnp.asarray(False),
    )


class HostSamplingEngine:
    """arch0: NumPy sampling on host, jitted training on the chip."""

    def __init__(self, cfg: RunConfig, ds: Dataset):
        cfg.validate()
        self.cfg = cfg
        self.ds = ds
        self.indptr = np.asarray(ds.indptr)
        self.indices = np.asarray(ds.indices)
        st = cfg.sample_type
        if st == SampleType.RANDOM_WALK:
            fan_sampling = [cfg.num_neighbor] * cfg.num_layer_rw
        else:
            fan_sampling = list(reversed(cfg.fanout))
        caps = calibrate_caps(
            self.indptr, self.indices, np.asarray(ds.train_set),
            cfg.batch_size, fan_sampling, seed=cfg.seed,
            replace=(st == SampleType.KHOP1),
        )
        self.plan = make_plan(cfg.batch_size, list(reversed(fan_sampling)),
                              ds.num_node, unique_caps=caps)

        # per-hop sampler by type (cpu_sampling_*.cc dispatch analog)
        self._hop_fn = None
        if st in (SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_PREFIX,
                  SampleType.WEIGHTED_KHOP_HASH_DEDUP):
            if ds.prob_prefix_table is None:
                from .data.synthetic import build_alias_tables

                build_alias_tables(ds, seed=cfg.seed)
            # per-vertex prefix -> per-edge weights -> GLOBAL cumsum.
            # Vectorized un-prefix (cumsum-diff trick, cf. cache/policy.py):
            # diff is right everywhere except each vertex's FIRST edge,
            # where the weight is the prefix value itself.
            w = np.asarray(ds.prob_prefix_table, np.float64)
            d = np.empty_like(w)
            if w.size:
                np.subtract(w[1:], w[:-1], out=d[1:])
                d[0] = w[0]
            deg = np.diff(self.indptr)
            starts = self.indptr[:-1][deg > 0]
            d[starts] = w[starts]
            self._gcum = np.cumsum(d)
            dedup = st == SampleType.WEIGHTED_KHOP_HASH_DEDUP

            def _hop(rng, cur, f, hop, _d=dedup):
                return _np_weighted_hop(rng, self.indptr, self.indices,
                                        self._gcum, cur, f, dedup=_d)

            self._hop_fn = _hop
        elif st == SampleType.RANDOM_WALK:
            def _hop(rng, cur, K, hop):
                return _np_random_walk_hop(
                    rng, self.indptr, self.indices, cur, K,
                    cfg.num_random_walk, cfg.random_walk_length,
                    cfg.random_walk_restart_prob,
                )

            self._hop_fn = _hop
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.shuffler = EpochShuffler(
            ds.train_set, cfg.batch_size, self.plan.num_input_cap[0],
            base_seed=cfg.seed,
        )
        self.model = build_model(cfg.model, ds.feat_dim, cfg.num_hidden,
                                 ds.num_class, self.plan.num_layer,
                                 cfg.dropout)
        self.label = np.asarray(ds.label)
        self.rng = np.random.default_rng(cfg.seed)

        seeds0, n0, _ = next(self.shuffler.batches(0))
        batch0 = self._sample(self.rng, seeds0, n0)
        feats0 = jnp.asarray(host_gather(ds.feat, np.asarray(batch0.input_nodes),
                                         mod=ds.feat_mod))
        self.state, self.tx = create_train_state(
            self.model, jax.random.key(cfg.seed + 1), batch0, feats0,
            self.dst_caps, lr=cfg.lr, weight_decay=cfg.weight_decay,
        )
        step = make_train_step(self.model, self.tx, self.dst_caps,
                               cfg.batch_size)

        def train_only(state, batch, feats, labels, key):
            return step(state, batch, feats, labels, key)

        self.train_jit = jax.jit(train_only, donate_argnums=(0,))

        # --- optional HBM feature cache (reference CPUEngine can pair
        # with GPUCacheManager, cpu_engine.cc:82-90): host sampling, hot
        # rows resident on the chip, host gather only for misses --------
        self.cache = None
        if cfg.use_cache:
            from .cache.manager import FeatureCache
            from .cache.policy import build_ranking
            from .config import CachePolicy

            if cfg.cache_policy in (CachePolicy.PRESAMPLE,
                                    CachePolicy.PRESAMPLE_STATIC):
                ranking = self._np_presample_ranking()
            else:
                ranking = build_ranking(ds, cfg.cache_policy, seed=cfg.seed)
            self.cache = FeatureCache(
                np.asarray(ds.feat), ranking, cfg.cache_percentage,
                ds.num_node, empty_feat=ds.empty_feat,
            )
        log.info("HostSamplingEngine (arch0): %d steps/epoch, cache=%s",
                 self.shuffler.num_step,
                 "off" if self.cache is None else
                 f"{cfg.cache_percentage:.0%}/{cfg.cache_policy.value}")

    def _sample(self, rng, seeds, n) -> SampledBatch:
        return np_multi_layer_sample(
            rng, self.indptr, self.indices, seeds, n, self.plan,
            replace=(self.cfg.sample_type == SampleType.KHOP1),
            hop_fn=self._hop_fn,
        )

    def _np_presample_ranking(self) -> np.ndarray:
        """PreSampler analog on the host sampler (pre_sampler.cc:57-132):
        run presample_epoch epochs of the REAL sampler, count node
        accesses, rank hottest-first."""
        cfg = self.cfg
        freq = np.zeros(self.ds.num_node, dtype=np.int64)
        rng = np.random.default_rng(cfg.seed + 41)
        for ep in range(max(1, cfg.presample_epoch)):
            for seeds, n, _ in self.shuffler.batches(ep):
                b = self._sample(rng, seeds, n)
                ids = np.asarray(b.input_nodes)
                ids = ids[ids >= 0]
                np.add.at(freq, ids, 1)
        return np.argsort(-freq, kind="stable").astype(np.int32)

    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        t_epoch = Timer()
        losses, accs = [], []
        base = jax.random.key(cfg.seed + 99)
        prof = Profiler.get()
        for seeds, n, step in self.shuffler.batches(epoch):
            t = Timer()
            batch = self._sample(self.rng, seeds, n)
            skey = prof.step_key(epoch, step)
            st = t.passed()
            prof.log_step(skey, "L1_sample_time", st)
            prof.log_epoch_add(epoch, "epoch_sample_time", st)
            t.reset()
            # reference table1 splits Extract (the host feature gather,
            # DoCPUFeatureExtract) from Copy (host->device transfer)
            if self.cache is not None:
                idx = self.cache.get_miss_cache_index(batch.input_nodes)
                miss_t, _ = self.cache.upload_miss(idx)
                et = t.passed()
                t.reset()
                feats = self.cache.combine(idx, miss_t)
                F = miss_t.shape[1]
                prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                   float(int(idx.num_miss) * F * 4))
                prof.log_epoch_add(
                    epoch, "epoch_feature_bytes",
                    float(int(batch.num_input) * F * 4),
                )
            else:
                feats_h = host_gather(
                    self.ds.feat, np.asarray(batch.input_nodes),
                    mod=self.ds.feat_mod,
                )
                et = t.passed()
                t.reset()
                feats = jnp.asarray(feats_h)
            prof.log_step(skey, "L2_extract_time", et)
            prof.log_epoch_add(epoch, "epoch_extract_time", et)
            if cfg.profile_level >= 2:
                jax.block_until_ready(feats)
            ct = t.passed()
            prof.log_step(skey, "L1_copy_time", ct + et)
            prof.log_epoch_add(epoch, "epoch_copy_time", ct)
            t.reset()
            out = np.asarray(batch.output_nodes)
            labels = jnp.asarray(
                np.where(out >= 0, self.label[np.maximum(out, 0)], -1)
            )
            key = jax.random.fold_in(base, epoch * self.shuffler.num_step + step)
            self.state, loss, acc = self.train_jit(
                self.state, batch, feats, labels, key
            )
            if cfg.profile_level >= 2:
                jax.block_until_ready(loss)  # true train-stage time, not dispatch
            losses.append(loss)
            accs.append(acc)
            tt = t.passed()
            prof.log_step(skey, "L1_train_time", tt)
            prof.log_epoch_add(epoch, "epoch_train_time", tt)
        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
        epoch_time = t_epoch.passed()
        Profiler.get().log_epoch_add(epoch, "epoch_total_time", epoch_time)
        return {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(np.mean(losses)) if losses else 0.0,
            "acc": float(np.mean(accs)) if accs else 0.0,
            "num_step": self.shuffler.num_step,
        }
