"""Single-chip engine (arch1 analog).

Reference: GPUEngine (samgraph/common/cuda/cuda_engine.cc) running arch1 —
sample, extract and train all on one accelerator. The twist here: when
features are device-resident the whole sample->extract->train pipeline is ONE
jitted function (no host round trips, XLA overlaps everything); only for
host-resident features (papers100M-scale) does the step split into
sample_jit -> host gather -> train_jit, the arch2/3 shape.

Multi-chip factored/SGNN engines live in fgnn_tpu.parallel.factored.
"""
from __future__ import annotations

import os

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants
from .config import CachePolicy, RunConfig, SampleType
from .data.schema import Dataset
from .models import build_model
from .ops.extract import (device_gather, host_gather, label_gather,
                          mock_gather)
from .ops.padding import make_plan
from .ops.reference_impl import calibrate_caps
from .ops.sampling import (CSRGraph, SampledBatch, multi_layer_sample,
                           sample_layer)
from .ops.random_walk import random_walk_topk
from .parallel.shuffler import EpochShuffler
from .placement import ENV_FEAT_BUDGET, feat_budget, features_fit
from .train.loop import create_train_state, make_train_step, make_eval_step
from .utils import Timer, get_logger
from .utils.profiler import Profiler

log = get_logger(__name__)


class OneChipEngine:
    def __init__(
        self,
        cfg: RunConfig,
        ds: Dataset,
        feat_hbm_budget: Optional[int] = None,
    ):
        """``feat_hbm_budget``: bytes of device memory the feature table
        may take; None derives it from the device (placement.feat_budget).
        The FGNN_TPU_FEAT_HBM_BUDGET environment variable overrides both."""
        cfg.validate()
        self.cfg = cfg
        self.ds = ds
        prof = Profiler.get()
        # cfg-requested detail unlocks the matching log_step gates even when
        # FGNN_TPU_PROFILE_LEVEL wasn't exported (library users)
        prof.level = max(prof.level, cfg.profile_level)
        t = Timer()
        t_copy = Timer()  # device-placement spans (SampleDataCopy analog)
        copy_s = 0.0

        # --- topology to device (SampleDataCopy analog) -------------------
        indptr = np.asarray(ds.indptr)
        if ds.num_edge >= 2**31 and not jax.config.jax_enable_x64:
            # jnp.asarray would silently downcast int64 indptr to int32 and
            # corrupt neighbor offsets — fail loudly instead (uk-union scale
            # needs jax_enable_x64)
            raise ValueError(
                f"graph has {ds.num_edge} >= 2^31 edges; int64 indptr "
                "requires jax_enable_x64 "
                "(jax.config.update('jax_enable_x64', True) before engine "
                "construction)"
            )
        ptr_dtype = np.int32 if ds.num_edge < 2**31 else np.int64

        def pad_lane(a):
            # lane-align per-edge arrays for blocked 1D gathers
            from .ops.sampling import INDICES_LANE

            a = np.asarray(a)
            rem = (-len(a)) % INDICES_LANE
            return np.pad(a, (0, rem)) if rem else a

        self.graph = CSRGraph(
            indptr=jnp.asarray(indptr.astype(ptr_dtype)),
            indices=jnp.asarray(pad_lane(ds.indices)),
            prob_table=(
                jnp.asarray(pad_lane(ds.prob_table))
                if ds.prob_table is not None
                and cfg.sample_type in (SampleType.WEIGHTED_KHOP,
                                        SampleType.WEIGHTED_KHOP_HASH_DEDUP)
                else None
            ),
            alias_table=(
                jnp.asarray(pad_lane(ds.alias_table))
                if ds.alias_table is not None
                and cfg.sample_type in (SampleType.WEIGHTED_KHOP,
                                        SampleType.WEIGHTED_KHOP_HASH_DEDUP)
                else None
            ),
            prob_prefix_table=(
                jnp.asarray(pad_lane(ds.prob_prefix_table))
                if ds.prob_prefix_table is not None
                and cfg.sample_type in (
                    SampleType.WEIGHTED_KHOP_PREFIX,
                    # hash-dedup recovers exact weights from the prefix
                    # table for its Gumbel top-k branch
                    SampleType.WEIGHTED_KHOP_HASH_DEDUP,
                )
                else None
            ),
        )
        jax.block_until_ready(self.graph.indices)
        copy_s += t_copy.passed()

        # --- static plan via NumPy calibration ----------------------------
        if cfg.sample_type == SampleType.RANDOM_WALK:
            fan_sampling = [cfg.num_neighbor] * cfg.num_layer_rw
        else:
            fan_sampling = list(reversed(cfg.fanout))
        # degree-tiered last hop (ops/sampling._tiered_last_hop): only for
        # the no-dedup fast path's samplers — take-all on the small tier is
        # distribution-identical ONLY for uniform-without-replacement,
        # and GCN keeps last-hop dedup (out-degree norm). Disable via
        # FGNN_TPU_TIERED_HOP=0.
        tiered_ok = (
            cfg.sample_type in (SampleType.KHOP0, SampleType.KHOP2)
            and cfg.model != "gcn"
            and os.environ.get("FGNN_TPU_TIERED_HOP", "1")
            not in ("0", "false")
        )
        tier_stats = None
        if tiered_ok:
            caps, tier_stats = calibrate_caps(
                indptr, np.asarray(ds.indices), np.asarray(ds.train_set),
                cfg.batch_size, fan_sampling, seed=cfg.seed,
                replace=False,
                tier_candidates=(4, 6, 8, 10, 12, 14, 16, 20),
            )
        else:
            caps = calibrate_caps(
                indptr, np.asarray(ds.indices), np.asarray(ds.train_set),
                cfg.batch_size, fan_sampling, seed=cfg.seed,
                replace=(cfg.sample_type == SampleType.KHOP1),
            )
        self.plan = make_plan(
            cfg.batch_size,
            list(reversed(fan_sampling)),   # make_plan reverses again
            ds.num_node,
            unique_caps=caps,
            tier_stats=tier_stats,
        )
        log.info("sample plan: %s", self.plan)

        # --- feature placement -------------------------------------------
        self.compute_dtype = (
            jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        )
        feat_itm = 2 if self.compute_dtype is not None else 4
        feat_bytes = ds.feat.shape[0] * ds.feat.shape[1] * feat_itm
        if feat_hbm_budget is None or ENV_FEAT_BUDGET in os.environ:
            graph_bytes = sum(x.nbytes for x in jax.tree.leaves(self.graph))
            feat_hbm_budget = feat_budget(graph_bytes)
        self.feat_budget = feat_hbm_budget
        self.feat_on_device = features_fit(feat_bytes, feat_hbm_budget)
        t_copy = Timer()
        if self.feat_on_device:
            # bf16 table halves both HBM residency and gather bandwidth
            self.feat_dev = jnp.asarray(
                np.asarray(ds.feat),
                dtype=self.compute_dtype or jnp.float32,
            )
        else:
            self.feat_dev = None
        self.label_dev = jnp.asarray(np.asarray(ds.label))
        jax.block_until_ready(self.label_dev)
        copy_s += t_copy.passed()

        # --- shuffler ------------------------------------------------------
        self.shuffler = EpochShuffler(
            ds.train_set, cfg.batch_size, self.plan.num_input_cap[0],
            base_seed=cfg.seed,
        )
        prof.set_num_step(self.shuffler.num_step)

        # --- feature cache (arch2/3 with GPU cache analog) ----------------
        # only meaningful when features are host-resident; a presample or
        # static ranking pins the hot slice in HBM
        self.cache = None
        self.dyn_cache = None
        if cfg.use_cache and not self.feat_on_device and (
            cfg.cache_policy == CachePolicy.DYNAMIC_CACHE
        ):
            # arch4: cache replaced per step with the previous batch
            from .cache.dynamic import DynamicFeatureCache

            self.dyn_cache = DynamicFeatureCache(
                np.asarray(ds.feat) if not hasattr(ds.feat, "filename")
                else ds.feat,
                self.plan.final_input_cap,
                mod=ds.feat_mod,
            )
        elif cfg.use_cache and not self.feat_on_device:
            _sg = jax.jit(lambda g, k, s, n: self._sample(g, k, s, n))
            sample_fn = lambda k, s, n: _sg(self.graph, k, s, n)
            if cfg.cache_policy == CachePolicy.PRESAMPLE_STATIC:
                from .cache.presample import presample_static_ranking

                ranking = presample_static_ranking(
                    sample_fn, self.shuffler, indptr, np.asarray(ds.indices),
                    ds.num_node, presample_epoch=cfg.presample_epoch,
                    seed=cfg.seed,
                )
            elif cfg.cache_policy == CachePolicy.PRESAMPLE:
                from .cache.presample import presample_ranking

                ranking = presample_ranking(
                    sample_fn, self.shuffler, ds.num_node,
                    presample_epoch=cfg.presample_epoch, seed=cfg.seed,
                )
            else:
                from .cache.policy import build_ranking

                ranking = build_ranking(ds, cfg.cache_policy, cfg.seed)
            from .cache.manager import FeatureCache

            self.cache = FeatureCache(
                np.asarray(ds.feat) if not hasattr(ds.feat, "filename")
                else ds.feat,
                ranking, cfg.cache_percentage, ds.num_node,
                dtype=(jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else None),
                empty_feat=ds.empty_feat,
            )

        # --- opt-in runtime sanity checks (SAMGRAPH_SANITY_CHECK analog) --
        from .config import env_flag
        self.sanity = None
        if cfg.sanity_check or env_flag(constants.ENV_SANITY_CHECK):
            from .ops.sanity import EpochSanityChecker

            self.sanity = EpochSanityChecker(ds.num_node)

        # --- model ---------------------------------------------------------
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            self.plan.num_layer, cfg.dropout, dtype=self.compute_dtype,
        )
        self._build_fns()

        # --- checkpoint/resume (reference has none) ----------------------
        self.ckpt = None
        self.start_epoch = 0
        if cfg.ckpt_dir:
            from .train.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(cfg.ckpt_dir)
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                state_h, epoch = restored
                self.state = jax.device_put(state_h)
                self.start_epoch = epoch + 1
        prof.log_init("init_copy", copy_s)
        prof.log_init("init_other", max(0.0, t.passed() - copy_s))

    # ------------------------------------------------------------------
    def _sample(self, graph, key, seeds, num_seeds,
                dedup_last_hop: bool = True) -> SampledBatch:
        """Sampling body. `graph` is threaded through as a jit ARGUMENT —
        closing over the device-resident CSR would embed it as an HLO
        constant and blow the program size past compile-service limits."""
        cfg = self.cfg
        if cfg.sample_type == SampleType.RANDOM_WALK:
            return random_walk_topk(
                key, graph, seeds, num_seeds, self.plan,
                num_random_walk=cfg.num_random_walk,
                random_walk_length=cfg.random_walk_length,
                restart_prob=cfg.random_walk_restart_prob,
                dedup_last_hop=dedup_last_hop,
            )
        return multi_layer_sample(
            key, graph, seeds, num_seeds, self.plan, cfg.sample_type,
            dedup_last_hop=dedup_last_hop,
            # GCN's norm='both' needs per-block src out-degrees; emitting
            # them from the dedup sort replaces the edge-stream
            # scatter-add (models/aggregate.py::out_degrees)
            with_out_degrees=cfg.model == "gcn",
        )

    def _build_fns(self):
        cfg = self.cfg
        plan = self.plan

        # big tables (graph/feat/label) enter every jitted fn as runtime
        # arguments, never closure constants — see _sample docstring
        self._sample_g = jax.jit(
            lambda graph, key, seeds, n, dedup: self._sample(
                graph, key, seeds, n, dedup_last_hop=dedup
            ),
            static_argnums=(4,),
        )
        self.sample_jit = lambda key, seeds, n, dedup=True: self._sample_g(
            self.graph, key, seeds, n, dedup
        )
        # dedup mode the actual train step uses — observability resamples
        # (sanity / node-access) must match it batch-for-batch
        self._train_dedup = True

        # init model params with one (cheap, any-key) sample
        seeds0, n0, _ = next(self.shuffler.batches(0))
        batch0 = self.sample_jit(
            jax.random.key(cfg.seed), jnp.asarray(seeds0), jnp.int32(n0)
        )
        if self.feat_on_device:
            feats0 = device_gather(self.feat_dev, batch0.input_nodes)
        else:
            feats0 = jnp.asarray(
                host_gather(self.ds.feat, np.asarray(batch0.input_nodes),
                            mod=self.ds.feat_mod)
            )
        self.state, self.tx = create_train_state(
            self.model, jax.random.key(cfg.seed + 1), batch0, feats0,
            self.dst_caps, lr=cfg.lr, weight_decay=cfg.weight_decay,
        )
        train_step = make_train_step(self.model, self.tx, self.dst_caps,
                                     cfg.batch_size)
        self.eval_step = jax.jit(
            make_eval_step(self.model, self.dst_caps, cfg.batch_size)
        )

        # train-only step (used by the split path, and by profile_level>=2
        # de-fused stage timing on the HBM-resident path)
        def train_only(state, label, key, batch, feats):
            labels = label_gather(label, batch.output_nodes)
            k_drop = jax.random.fold_in(key, 0x5eed)
            new_state, loss, acc = train_step(
                state, batch, feats, labels, k_drop
            )
            return new_state, loss, acc

        self._train_g = jax.jit(train_only, donate_argnums=(0,))
        self.train_jit = lambda state, key, batch, feats: self._train_g(
            state, self.label_dev, key, batch, feats
        )
        # empty-feat mode (explicit Dataset.empty_feat flag): modulo
        # indexing like GPUMockExtract (cuda_extraction.cu:51-72)
        feat_gather = mock_gather if self.ds.empty_feat else device_gather
        self._gather_g = jax.jit(feat_gather)

        if self.feat_on_device:
            # HBM-resident features: skip last-hop dedup (see
            # multi_layer_sample docstring) — duplicate feature-row reads
            # are cheaper than the dedup sort+unscatter at these sizes.
            # EXCEPT GCN: its 1/sqrt(out_degree) source normalization
            # counts block occurrences, which dedup-skipping changes
            # (mean/weighted-mean/softmax aggregations are invariant).
            dedup = cfg.model == "gcn"
            self._train_dedup = dedup

            def fused_step(state, graph, feat, label, key, seeds, num_seeds):
                batch = self._sample(graph, key, seeds, num_seeds,
                                     dedup_last_hop=dedup)
                feats = feat_gather(feat, batch.input_nodes)
                labels = label_gather(label, batch.output_nodes)
                k_drop = jax.random.fold_in(key, 0x5eed)
                new_state, loss, acc = train_step(
                    state, batch, feats, labels, k_drop
                )
                n_edges = sum(
                    jnp.sum(b.mask).astype(jnp.int32) for b in batch.blocks
                )
                return new_state, loss, acc, n_edges, batch.overflowed

            self._fused_g = jax.jit(fused_step, donate_argnums=(0,))
            self.fused_step = lambda state, key, seeds, n: self._fused_g(
                state, self.graph, self.feat_dev, self.label_dev,
                key, seeds, n,
            )

            # whole-epoch program: lax.scan over steps — ONE dispatch and
            # ONE stats fetch per epoch, so no per-step Python dispatch or
            # host sync sits between steps.
            def epoch_fused(state, graph, feat, label, epoch_key,
                            seeds_all, nums_all):
                def body(st, inp):
                    seeds, n, i = inp
                    key = jax.random.fold_in(epoch_key, i)
                    st, loss, acc, n_edges, ovf = fused_step(
                        st, graph, feat, label, key, seeds, n
                    )
                    return st, (loss, acc, n_edges, ovf)

                steps = seeds_all.shape[0]
                idx = jnp.arange(steps, dtype=jnp.int32)
                state, (losses, accs, edges, ovfs) = jax.lax.scan(
                    body, state, (seeds_all, nums_all, idx)
                )
                w = (nums_all > 0).astype(jnp.float32)
                wsum = jnp.maximum(w.sum(), 1.0)
                return state, (
                    (losses * w).sum() / wsum,
                    (accs * w).sum() / wsum,
                    edges.sum(),
                    ovfs.any(),
                )

            self._epoch_g = jax.jit(epoch_fused, donate_argnums=(0,))

            # software-pipelined epoch: each scan iteration trains on the
            # batch PRODUCED IN THE PREVIOUS iteration while producing the
            # next one. The two halves share no data dependence, so XLA's
            # scheduler may overlap the feature gather with the fwd/bwd
            # math — the sequential form serializes them (gather -> train
            # -> gather...). Math is
            # bit-identical to epoch_fused: same batches, same keys, same
            # order (test_pipelined_epoch). Opt in/out via
            # FGNN_TPU_PIPELINE_EPOCH; the carry holds one prefetched
            # batch (+~1GB device memory at bench caps — the double
            # buffer).
            def produce(graph, feat, label, epoch_key, seeds, n, i):
                key = jax.random.fold_in(epoch_key, i)
                batch = self._sample(graph, key, seeds, n,
                                     dedup_last_hop=dedup)
                feats = feat_gather(feat, batch.input_nodes)
                labels = label_gather(label, batch.output_nodes)
                n_edges = sum(
                    jnp.sum(b.mask).astype(jnp.int32) for b in batch.blocks
                )
                return (batch, feats, labels, key, n_edges,
                        batch.overflowed)

            def train_on(st, pre):
                batch, feats, labels, key, n_edges, ovf = pre
                k_drop = jax.random.fold_in(key, 0x5eed)
                st2, loss, acc = train_step(st, batch, feats, labels,
                                            k_drop)
                return st2, (loss, acc, n_edges, ovf)

            def epoch_pipelined(state, graph, feat, label, epoch_key,
                                seeds_all, nums_all):
                steps = seeds_all.shape[0]
                pre0 = produce(graph, feat, label, epoch_key,
                               seeds_all[0], nums_all[0], jnp.int32(0))

                def body(carry, inp):
                    st, pre = carry
                    seeds, n, i = inp
                    st2, out = train_on(st, pre)             # step i-1
                    pre2 = produce(graph, feat, label, epoch_key,
                                   seeds, n, i)              # step i
                    return (st2, pre2), out

                idx = jnp.arange(1, steps, dtype=jnp.int32)
                (state, last), (losses, accs, edges, ovfs) = jax.lax.scan(
                    body, (state, pre0),
                    (seeds_all[1:], nums_all[1:], idx),
                )
                state, (l_l, a_l, e_l, o_l) = train_on(state, last)
                losses = jnp.concatenate([losses, l_l[None]])
                accs = jnp.concatenate([accs, a_l[None]])
                edges = jnp.concatenate([edges, e_l[None]])
                ovfs = jnp.concatenate([ovfs, o_l[None]])
                w = (nums_all > 0).astype(jnp.float32)
                wsum = jnp.maximum(w.sum(), 1.0)
                return state, (
                    (losses * w).sum() / wsum,
                    (accs * w).sum() / wsum,
                    edges.sum(),
                    ovfs.any(),
                )

            self._epoch_pipe_g = jax.jit(epoch_pipelined,
                                         donate_argnums=(0,))
            pipe = os.environ.get("FGNN_TPU_PIPELINE_EPOCH", "0") == "1"
            epoch_g = self._epoch_pipe_g if pipe else self._epoch_g
            self.epoch_fused = (
                lambda state, epoch_key, seeds_all, nums_all: epoch_g(
                    state, self.graph, self.feat_dev, self.label_dev,
                    epoch_key, seeds_all, nums_all,
                )
            )
        else:
            self.fused_step = None

    # ------------------------------------------------------------------
    def _surface_overflow(self, epoch: int, overflowed: bool):
        """Sampler cap overflow silently clips sampled nodes/edges — surface
        it (warning + profiler counter; hard error under sanity mode).
        `calibrate_caps` probes only 2 batches, so this is the runtime
        backstop the padding contract promises (ops/padding.py)."""
        if not overflowed:
            return
        prof = Profiler.get()
        prof.log_epoch_add(epoch, "epoch_cap_overflow", 1.0)
        msg = (
            f"epoch {epoch}: sampler cap overflow — a batch exceeded the "
            f"calibrated unique/edge caps {self.plan.num_unique_cap}/"
            f"{self.plan.num_edge_cap} and was clipped (dropped neighbors). "
            "Raise constants.ALLOC_SCALE or calibrate_caps num_probe."
        )
        if self.cfg.sanity_check or self.sanity is not None:
            raise RuntimeError(msg)
        log.warning(msg)

    def _profile_l3(self, key, seeds_dev, num, skey) -> None:
        """Measurement-only de-fused sub-op timing at profile_level >= 3.

        Re-runs the step's sampling workload (same key/seeds) as separate
        jitted sub-programs with a sync per op, writing the reference's L3
        per-kernel items (profiler.h:59-117 L3 taxonomy; timings the
        reference takes around each CUDA kernel pipeline) plus the L2
        stage aggregates they roll up into. The training batch itself
        still comes from the fused sampler — this path only measures.
        Only the khop family decomposes this way (random-walk is one
        fused scan).
        """
        if self.cfg.sample_type == SampleType.RANDOM_WALK:
            return
        prof = Profiler.get()
        plan = self.plan
        if not hasattr(self, "_l3_fns"):
            from .ops.hashtable import lookup_local_ids, unique_with_seeds

            st = self.cfg.sample_type
            samp, uniq, remap = [], [], []
            for hop in range(plan.num_layer):
                f = plan.fanouts[hop]
                ucap = plan.num_unique_cap[hop]
                icap = plan.num_input_cap[hop]
                # graph threaded as a jit ARGUMENT (see _sample docstring)
                samp.append(jax.jit(
                    lambda g, k, cur, f=f: sample_layer(k, g, cur, f, st)
                ))
                uniq.append(jax.jit(
                    lambda s, n, nb, ucap=ucap: unique_with_seeds(
                        s, n, nb, ucap)
                ))
                remap.append(jax.jit(
                    lambda u, nb, icap=icap: lookup_local_ids(u, icap, nb)
                ))
            self._l3_fns = (samp, uniq, remap)
        samp, uniq, remap = self._l3_fns
        cur, num_cur = seeds_dev, jnp.int32(num)
        core = remap_t = 0.0
        t = Timer()
        for hop in range(plan.num_layer):
            k = jax.random.fold_in(key, hop)
            t.reset()
            nbrs, valid, _ = samp[hop](self.graph, k, cur)
            jax.block_until_ready(valid)
            dt = t.passed()
            prof.log_step_add(skey, "L3_khop_sample_coo_time", dt)
            if prof.trace_enabled:
                prof.trace_event(skey, "kL2Event_Sample_Core",
                                 t._start * 1e6, Timer.now_us())
            core += dt
            t.reset()
            u_start = t._start
            unique, nu, _ovf = uniq[hop](cur, num_cur, nbrs)
            jax.block_until_ready(nu)
            du = t.passed()
            prof.log_step_add(skey, "L3_remap_unique_time", du)
            t.reset()
            src_local = remap[hop](unique, nbrs)
            jax.block_until_ready(src_local)
            dm = t.passed()
            prof.log_step_add(skey, "L3_remap_map_edge_time", dm)
            remap_t += du + dm
            if prof.trace_enabled:
                prof.trace_event(skey, "kL2Event_Sample_IdRemap",
                                 u_start * 1e6, Timer.now_us())
            cur, num_cur = unique, nu
        prof.log_step(skey, "L2_core_sample_time", core)
        prof.log_step(skey, "L2_id_remap_time", remap_t)

    # ------------------------------------------------------------------
    # fused-epoch dispatch helpers
    # ------------------------------------------------------------------
    def _epoch_arrays_dev(self, epoch: int):
        """Device-resident (seeds, nums, nums_host) for an epoch, using a
        previously prefetched upload when one matches."""
        pre = getattr(self, "_seed_prefetch", None)
        if pre is not None and pre[0] == epoch:
            self._seed_prefetch = None
            return pre[1], pre[2], pre[3]
        seeds_all, nums_all = self.shuffler.epoch_arrays(epoch)
        return jnp.asarray(seeds_all), jnp.asarray(nums_all), nums_all

    def _prefetch_epoch_seeds(self, epoch: int) -> None:
        """Issue the (async) H2D upload of an epoch's shuffled seed
        batches ahead of time so the transfer overlaps other host/device
        work (the reference overlaps its shuffler H2D with training the
        same way — GPUShuffler copies under the pipeline's streams)."""
        seeds_all, nums_all = self.shuffler.epoch_arrays(epoch)
        self._seed_prefetch = (
            epoch, jax.device_put(seeds_all), jax.device_put(nums_all),
            nums_all,
        )

    def _dispatch_fused_epoch(self, epoch: int):
        """Dispatch one whole fused epoch; returns a DEVICE stats vector
        [loss, acc, edges, overflow] — no host sync. Callers fetch."""
        cfg = self.cfg
        seeds_dev, nums_dev, nums_host = self._epoch_arrays_dev(epoch)
        epoch_key = jax.random.fold_in(
            jax.random.key(cfg.seed), 0x10000 + epoch
        )
        if os.environ.get("FGNN_TPU_PERSTEP_FUSED", "0") == "1":
            # Same math as epoch_fused, dispatched one fused step at
            # a time (async, no per-step sync): a smaller program to
            # compile than the whole-epoch scan, for very large caps.
            st = self.state
            ls, as_, es, os_ = [], [], [], []
            for i in range(nums_host.shape[0]):
                key = jax.random.fold_in(epoch_key, i)
                st, l, a, ne, ov = self.fused_step(
                    st, key, seeds_dev[i], nums_dev[i]
                )
                ls.append(l); as_.append(a); es.append(ne)
                os_.append(ov)
            self.state = st
            w = jnp.asarray((np.asarray(nums_host) > 0).astype(np.float32))
            wsum = jnp.maximum(w.sum(), 1.0)
            loss = (jnp.stack(ls) * w).sum() / wsum
            acc = (jnp.stack(as_) * w).sum() / wsum
            edges = jnp.stack(es).sum()
            ovf = jnp.stack(os_).any()
        else:
            self.state, (loss, acc, edges, ovf) = self.epoch_fused(
                self.state, epoch_key, seeds_dev, nums_dev,
            )
        return jnp.stack([loss, acc, edges.astype(jnp.float32),
                          ovf.astype(jnp.float32)])

    def run_epochs(self, start_epoch: int, n: int) -> list:
        """Dispatch ``n`` fused epochs back-to-back with ONE host sync at
        the end — per-epoch stats fetches disappear from the wall-clock.
        Identical math to ``n`` run_epoch calls (same programs, same keys,
        same order); per-epoch wall time is
        reported as total/n since individual boundaries are pipelined.
        Falls back to sequential run_epoch when the fused path is off."""
        cfg = self.cfg
        prof = Profiler.get()
        fused_ok = (
            self.fused_step is not None
            and self.sanity is None
            and cfg.profile_level < 2
            and not prof.log_node_access
            and not prof.trace_enabled
        )
        if not fused_ok:
            return [self.run_epoch(e) for e in range(start_epoch,
                                                     start_epoch + n)]
        t = Timer()
        stats_dev = []
        for e in range(start_epoch, start_epoch + n):
            stats_dev.append(self._dispatch_fused_epoch(e))
            if e + 1 < start_epoch + n:
                self._prefetch_epoch_seeds(e + 1)
        stats = np.asarray(jnp.stack(stats_dev))   # the one sync
        total = t.passed()
        out = []
        for i, e in enumerate(range(start_epoch, start_epoch + n)):
            self._surface_overflow(e, stats[i, 3] > 0)
            prof.log_epoch_add(e, "epoch_total_time", total / n)
            out.append({
                "epoch": e,
                "epoch_time": total / n,
                "loss": float(stats[i, 0]),
                "acc": float(stats[i, 1]),
                "num_step": self.shuffler.num_step,
                "sampled_edges": int(stats[i, 2]),
            })
        if self.ckpt is not None and cfg.ckpt_every > 0 and any(
            (e + 1) % cfg.ckpt_every == 0
            for e in range(start_epoch, start_epoch + n)
        ):
            # intermediate states are consumed by the pipelined dispatch;
            # checkpoint the final state at the last epoch of the window
            self.ckpt.save(start_epoch + n - 1, self.state)
        return out

    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        prof = Profiler.get()
        prof.begin_node_access_epoch()
        if self.sanity is not None:
            self.sanity.reset()
        t_epoch = Timer()

        # fast path: one scanned program per epoch. Falls back to the
        # stepwise loop when per-step observability is requested
        # (profile_level >= 2, sanity checks, node-access logging).
        if (
            self.fused_step is not None
            and self.sanity is None
            and cfg.profile_level < 2
            and not prof.log_node_access
            and not prof.trace_enabled
        ):
            stats_dev = self._dispatch_fused_epoch(epoch)
            # prefetch the NEXT epoch's seed upload: device_put is async,
            # so the ~1MB H2D overlaps this epoch's stats fetch
            self._prefetch_epoch_seeds(epoch + 1)
            stats = np.asarray(stats_dev)   # single device fetch
            self._surface_overflow(epoch, stats[3] > 0)
            epoch_time = t_epoch.passed()
            prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
            if (
                self.ckpt is not None
                and cfg.ckpt_every > 0
                and (epoch + 1) % cfg.ckpt_every == 0
            ):
                self.ckpt.save(epoch, self.state)
            return {
                "epoch": epoch,
                "epoch_time": epoch_time,
                "loss": float(stats[0]),
                "acc": float(stats[1]),
                "num_step": self.shuffler.num_step,
                "sampled_edges": int(stats[2]),
            }

        # pipelined split path (arch2/3 w/ cache): overlap the host miss
        # gather + upload of step k+1 with device training of step k —
        # the reference's SampleSubLoop ∥ DataCopySubLoop background
        # threads (cuda_loops_arch3.cc:178-216) as a 2-stage pipeline
        if (
            self.cache is not None
            and cfg.pipeline
            and self.sanity is None
            and not prof.log_node_access
            and not prof.trace_enabled
        ):
            return self._run_epoch_split_pipelined(epoch)

        # arch4 prefetch pipeline: the miss gather of batch k+1 (its split
        # depends only on batch k's IDS, not its features) overlaps the
        # training of batch k — the reference's DoGPUSampleDyCache
        # early-enqueue (cuda_loops_arch4.cc:69-73, cuda_loops.cc:269-498)
        if (
            self.dyn_cache is not None
            and cfg.pipeline
            and self.sanity is None
            and cfg.profile_level < 2
            and not prof.log_node_access
            and not prof.trace_enabled
        ):
            return self._run_epoch_dyncache_pipelined(epoch)

        losses, accs = [], []
        num_inputs = []
        ovfs = []
        base = jax.random.key(cfg.seed)
        for seeds, n, step in self.shuffler.batches(epoch):
            key = jax.random.fold_in(base, epoch * self.shuffler.num_step + step)
            skey = prof.step_key(epoch, step)
            t_step = Timer()  # L0Event_Train_Step span
            if self.sanity is not None:
                # deterministic RNG + same dedup mode: resampling with the
                # same key yields the exact batch the (possibly fused) step
                # trains on
                self.sanity.check_batch(
                    self.sample_jit(key, jnp.asarray(seeds), jnp.int32(n),
                                    dedup=self._train_dedup),
                    self.plan,
                )
            if self.fused_step is not None and cfg.profile_level < 2:
                t = Timer()
                self.state, loss, acc, n_edges, ovf = self.fused_step(
                    self.state, key, jnp.asarray(seeds), jnp.int32(n)
                )
                ovfs.append(ovf)
                if prof.trace_enabled:
                    # force completion so the event reflects device time;
                    # the fused program IS the whole step (one lane)
                    _ = float(loss)
                    prof.trace_event(skey, "kL0Event_Train_Step",
                                     t._start * 1e6, Timer.now_us())
                losses.append(loss)
                accs.append(acc)
                num_inputs.append(n_edges)
                prof.log_step(skey, "L1_train_time", t.passed())
                if prof.log_node_access:
                    # same key + same dedup mode ⇒ identical batch (incl.
                    # duplicate last-hop reads) as the fused step's
                    b = self.sample_jit(key, jnp.asarray(seeds), jnp.int32(n),
                                        dedup=self._train_dedup)
                    prof.log_node_access_batch(np.asarray(b.input_nodes))
            else:
                # de-fused path: host-resident features always run here;
                # profile_level>=2 routes the HBM-resident config here too
                # so each stage gets a true timer (same keys + same dedup mode
                # ⇒ identical training math as the fused program)
                t = Timer()
                seeds_dev = jnp.asarray(seeds)
                if cfg.profile_level >= 2:
                    # DoShuffle analog: batch-slice H2D upload time
                    prof.log_step(skey, "L2_shuffle_time", t.passed())
                if prof.trace_enabled:
                    prof.trace_event(skey, "kL2Event_Sample_Shuffle",
                                     t._start * 1e6, Timer.now_us())
                if cfg.profile_level >= 3:
                    self._profile_l3(key, seeds_dev, n, skey)
                    t.reset()  # L1 spans exclude measurement re-runs
                batch = self.sample_jit(key, seeds_dev, jnp.int32(n),
                                        dedup=self._train_dedup)
                ovfs.append(batch.overflowed)
                # fetch input ids to host only when a host-side consumer
                # needs them — the device->host link is the bottleneck of
                # the split pipeline
                in_nodes = None
                if (
                    not self.feat_on_device
                    and self.cache is None
                    and self.dyn_cache is None
                ) or prof.log_node_access:
                    tid = Timer()
                    in_nodes = np.asarray(batch.input_nodes)  # also syncs
                    if cfg.profile_level >= 2:
                        # DoIdCopy analog: input-ids D2H (includes waiting
                        # out the in-flight sample program)
                        prof.log_step(skey, "L2_id_copy_time", tid.passed())
                    if prof.trace_enabled:
                        prof.trace_event(skey, "kL2Event_Copy_Id",
                                         tid._start * 1e6, Timer.now_us())
                elif cfg.profile_level >= 2:
                    jax.block_until_ready(batch.num_input)
                st = t.passed()
                prof.log_step(skey, "L1_sample_time", st)
                prof.log_epoch_add(epoch, "epoch_sample_time", st)
                if prof.trace_enabled:
                    prof.trace_event(skey, "kL1Event_Sample", t._start * 1e6,
                                     Timer.now_us())
                t.reset()
                et = 0.0  # Extract portion of the copy stage (table1 split)
                if self.feat_on_device:
                    feats = self._gather_g(self.feat_dev, batch.input_nodes)
                    if cfg.profile_level >= 2:
                        jax.block_until_ready(feats)
                        prof.log_step(skey, "L2_extract_time", t.passed())
                    if prof.trace_enabled:
                        jax.block_until_ready(feats)
                        prof.trace_event(skey, "kL2Event_Copy_Extract",
                                         t._start * 1e6, Timer.now_us())
                    prof.log_epoch_add(epoch, "epoch_extract_time",
                                       t.passed())
                elif self.dyn_cache is not None:
                    feats = self.dyn_cache.extract(batch.input_nodes)
                    prof.log_epoch_add(
                        epoch, "epoch_miss_bytes",
                        float(self.dyn_cache.last_num_miss
                              * self.ds.feat.shape[1] * 4),
                    )
                    prof.log_epoch_add(
                        epoch, "epoch_feature_bytes",
                        float((self.dyn_cache.last_num_miss
                               + self.dyn_cache.last_num_hit)
                              * self.ds.feat.shape[1] * 4),
                    )
                elif self.cache is not None:
                    # miss/hit split + host gather of misses only; stage
                    # boundaries emit the reference's L3 CacheCopy trace
                    # events (profiler.h:153-159)
                    lvl2 = cfg.profile_level >= 2
                    t_cc = Timer()  # kL2Event_Copy_CacheCopy umbrella
                    tc = Timer()
                    index = self.cache.get_miss_cache_index(batch.input_nodes)
                    num_miss = int(index.num_miss)  # syncs the split
                    t_idx = tc.passed()
                    et += t_idx
                    if lvl2:
                        prof.log_step(skey, "L2_cache_get_index_time",
                                      t_idx)
                    if prof.trace_enabled:
                        prof.trace_event(skey,
                                         "kL3Event_Copy_CacheCopy_GetIndex",
                                         tc._start * 1e6, Timer.now_us())
                    tc.reset()
                    miss_t, _ = self.cache.upload_miss(index, num_miss,
                                                       trace_key=skey)
                    t_miss = tc.passed()
                    et += t_miss
                    if lvl2:
                        prof.log_step(skey, "L2_cache_extract_miss_time",
                                      t_miss)
                    tc.reset()
                    feats = self.cache.combine(index, miss_t)
                    if lvl2 or prof.trace_enabled:
                        jax.block_until_ready(feats)
                    if lvl2:
                        # upload of the miss rows + the hit/miss scatter
                        # merge in one span (DoCacheFeatureCopy steps 5-6)
                        prof.log_step(skey, "L2_cache_combine_miss_time",
                                      tc.passed())
                    if prof.trace_enabled:
                        # ONE combine program covers both reference lanes
                        # (CombineMiss + CombineCache); emitted on the first
                        prof.trace_event(skey,
                                         "kL3Event_Copy_CacheCopy_CombineMiss",
                                         tc._start * 1e6, Timer.now_us())
                        prof.trace_event(skey, "kL2Event_Copy_CacheCopy",
                                         t_cc._start * 1e6, Timer.now_us())
                    itm = miss_t.dtype.itemsize
                    prof.log_step(
                        skey, "L1_miss_nbytes",
                        float(num_miss * miss_t.shape[1] * itm),
                    )
                    prof.log_epoch_add(
                        epoch, "epoch_miss_bytes",
                        float(num_miss * miss_t.shape[1] * itm),
                    )
                    prof.log_epoch_add(
                        epoch, "epoch_feature_bytes",
                        float(int(batch.num_input) * miss_t.shape[1] * itm),
                    )
                else:
                    th = Timer()
                    feats_h = host_gather(self.ds.feat, in_nodes,
                                          mod=self.ds.feat_mod)
                    et += th.passed()
                    if cfg.profile_level >= 2:
                        prof.log_step(skey, "L2_extract_time", th.passed())
                    if prof.trace_enabled:
                        prof.trace_event(skey, "kL2Event_Copy_Extract",
                                         th._start * 1e6, Timer.now_us())
                    th.reset()
                    feats = jnp.asarray(feats_h)
                    if cfg.profile_level >= 2:
                        jax.block_until_ready(feats)
                        prof.log_step(skey, "L2_feat_copy_time", th.passed())
                    if prof.trace_enabled:
                        jax.block_until_ready(feats)
                        prof.trace_event(skey, "kL2Event_Copy_FeatCopy",
                                         th._start * 1e6, Timer.now_us())
                ct = t.passed()
                prof.log_step(skey, "L1_copy_time", ct)
                if not self.feat_on_device:
                    # table1 split: Extract (host gather / cache miss
                    # extraction) vs Copy (host->device transfer + merge)
                    prof.log_epoch_add(epoch, "epoch_extract_time", et)
                    prof.log_epoch_add(epoch, "epoch_copy_time",
                                       max(ct - et, 0.0))
                if prof.trace_enabled:
                    prof.trace_event(skey, "kL1Event_Copy", t._start * 1e6,
                                     Timer.now_us())
                prof.log_step(
                    skey, "L1_feature_bytes",
                    float(feats.size * feats.dtype.itemsize),
                )
                t.reset()
                self.state, loss, acc = self.train_jit(
                    self.state, key, batch, feats
                )
                if cfg.profile_level >= 2:
                    jax.block_until_ready(loss)
                losses.append(loss)
                accs.append(acc)
                prof.log_step(skey, "L1_train_time", t.passed())
                prof.log_epoch_add(epoch, "epoch_train_time", t.passed())
                if prof.trace_enabled:
                    _ = float(loss)
                    prof.trace_event(skey, "kL1Event_Train", t._start * 1e6,
                                     Timer.now_us())
                    prof.trace_event(skey, "kL0Event_Train_Step",
                                     t_step._start * 1e6, Timer.now_us())
                if prof.log_node_access and in_nodes is not None:
                    prof.log_node_access_batch(in_nodes)
        # one device sync at epoch end — losses force completion
        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
        if ovfs:
            self._surface_overflow(
                epoch, bool(np.any(np.asarray(jnp.stack(ovfs))))
            )
        sampled_edges = int(sum(int(x) for x in num_inputs)) if num_inputs else 0
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        if (
            self.ckpt is not None
            and cfg.ckpt_every > 0
            and (epoch + 1) % cfg.ckpt_every == 0
        ):
            self.ckpt.save(epoch, self.state)
        return {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(np.mean(losses)) if losses else 0.0,
            "acc": float(np.mean(accs)) if accs else 0.0,
            "num_step": self.shuffler.num_step,
            "sampled_edges": sampled_edges,
        }

    def _run_epoch_dyncache_pipelined(self, epoch: int) -> dict:
        """arch4 epoch with the prefetch pipeline: stage A (sample batch
        k+1 + split vs batch k's ids + host miss gather on a worker
        thread) overlaps stage B (combine + train of batch k). Identical
        math to the synchronous ``dyn_cache.extract`` path — the split of
        batch k+1 never needs batch k's features, only its ids
        (tests/test_dynamic_cache.py pins the equality)."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        prof = Profiler.get()
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        steps = list(self.shuffler.batches(epoch))
        losses, accs, ovfs = [], [], []
        dc = self.dyn_cache
        fdim = self.ds.feat.shape[1]
        ex = ThreadPoolExecutor(max_workers=2)
        try:
            def stage_a(item):
                seeds, n, step = item
                key = jax.random.fold_in(
                    base, epoch * self.shuffler.num_step + step
                )
                batch = self.sample_jit(key, jnp.asarray(seeds),
                                        jnp.int32(n),
                                        dedup=self._train_dedup)
                ovfs.append(batch.overflowed)
                split = dc.split_and_advance(batch.input_nodes)
                n_miss = int(split.num_miss)   # syncs the split
                ids_np = np.asarray(split.miss_ids)
                fut = ex.submit(
                    lambda: jnp.asarray(dc.gather_miss(ids_np, n_miss))
                )
                return key, batch, split, n_miss, fut

            pending = stage_a(steps[0])
            for i in range(len(steps)):
                key, batch, split, n_miss, fut = pending
                if i + 1 < len(steps):
                    # launches batch k+1's host miss gather — it runs on
                    # the worker thread while batch k trains below
                    pending = stage_a(steps[i + 1])
                feats = dc.combine(split, fut.result())
                self.state, loss, acc = self.train_jit(
                    self.state, key, batch, feats
                )
                losses.append(loss)
                accs.append(acc)
                skey = prof.step_key(epoch, steps[i][2])
                prof.log_step(skey, "L1_miss_nbytes",
                              float(n_miss * fdim * 4))
                prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                   float(n_miss * fdim * 4))
                prof.log_epoch_add(
                    epoch, "epoch_feature_bytes",
                    float((n_miss + dc.last_num_hit) * fdim * 4),
                )
        finally:
            ex.shutdown(wait=True)

        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
        if ovfs:
            self._surface_overflow(
                epoch, bool(np.any(np.asarray(jnp.stack(ovfs))))
            )
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        if (
            self.ckpt is not None
            and cfg.ckpt_every > 0
            and (epoch + 1) % cfg.ckpt_every == 0
        ):
            self.ckpt.save(epoch, self.state)
        return {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(np.mean(losses)) if losses else 0.0,
            "acc": float(np.mean(accs)) if accs else 0.0,
            "num_step": self.shuffler.num_step,
            "sampled_edges": 0,
        }

    def _run_epoch_split_pipelined(self, epoch: int) -> dict:
        """Cache-mode epoch with a 2-stage pipeline: stage A (device
        sample + miss index + host gather + async upload) runs one step
        ahead of stage B (combine + train). The host gather happens on a
        worker thread; jax async dispatch overlaps the device work."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        prof = Profiler.get()
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        steps = list(self.shuffler.batches(epoch))
        losses, accs, ovfs = [], [], []
        ex = ThreadPoolExecutor(max_workers=2)
        # profile_level>=2: per-stage timers with a device sync per stage
        # (the documented force-sync mode; perturbs but does not disable
        # the host-gather overlap) — this is what fills table1/table5's
        # Sample/Extract columns in pipelined cache mode
        sync_stages = cfg.profile_level >= 2
        try:
            def stage_a(item):
                seeds, n, step = item
                key = jax.random.fold_in(
                    base, epoch * self.shuffler.num_step + step
                )
                skey = prof.step_key(epoch, step)
                t = Timer()
                batch = self.sample_jit(key, jnp.asarray(seeds), jnp.int32(n))
                ovfs.append(batch.overflowed)
                index = self.cache.get_miss_cache_index(batch.input_nodes)
                if sync_stages:
                    jax.block_until_ready(index.num_miss)
                    st = t.passed()
                    prof.log_step(skey, "L1_sample_time", st)
                    prof.log_epoch_add(epoch, "epoch_sample_time", st)

                def host_part():
                    # device fetch + host gather + async upload, all off
                    # the main thread (bucketed — see upload_miss)
                    tc = Timer()
                    out, num_miss = self.cache.upload_miss(index)
                    if sync_stages:
                        jax.block_until_ready(out)
                        ct = tc.passed()
                        prof.log_step(skey, "L1_copy_time", ct)
                        prof.log_epoch_add(epoch, "epoch_copy_time", ct)
                    return (out, num_miss, out.shape[1],
                            out.dtype.itemsize)

                return key, batch, index, ex.submit(host_part)

            pending = stage_a(steps[0])
            for i in range(len(steps)):
                key, batch, index, fut = pending
                if i + 1 < len(steps):
                    pending = stage_a(steps[i + 1])
                miss_t, num_miss, fdim, itm = fut.result()
                tt = Timer()
                feats = self.cache.combine(index, miss_t)
                self.state, loss, acc = self.train_jit(
                    self.state, key, batch, feats
                )
                losses.append(loss)
                accs.append(acc)
                skey = prof.step_key(epoch, steps[i][2])
                if sync_stages:
                    jax.block_until_ready(loss)
                    tr = tt.passed()
                    prof.log_step(skey, "L1_train_time", tr)
                    prof.log_epoch_add(epoch, "epoch_train_time", tr)
                prof.log_step(skey, "L1_miss_nbytes",
                              float(num_miss * fdim * itm))
                prof.log_epoch_add(epoch, "epoch_miss_bytes",
                                   float(num_miss * fdim * itm))
                prof.log_epoch_add(
                    epoch, "epoch_feature_bytes",
                    float(int(batch.num_input) * fdim * itm),
                )
        finally:
            ex.shutdown(wait=True)

        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
        if ovfs:
            self._surface_overflow(
                epoch, bool(np.any(np.asarray(jnp.stack(ovfs))))
            )
        epoch_time = t_epoch.passed()
        prof.log_epoch_add(epoch, "epoch_total_time", epoch_time)
        if (
            self.ckpt is not None
            and cfg.ckpt_every > 0
            and (epoch + 1) % cfg.ckpt_every == 0
        ):
            self.ckpt.save(epoch, self.state)
        return {
            "epoch": epoch,
            "epoch_time": epoch_time,
            "loss": float(np.mean(losses)) if losses else 0.0,
            "acc": float(np.mean(accs)) if accs else 0.0,
            "num_step": self.shuffler.num_step,
            "sampled_edges": 0,
        }

    def evaluate(self, node_set: Optional[np.ndarray] = None) -> float:
        """Accuracy over test set (train_accuracy.py analog)."""
        cfg = self.cfg
        nodes = np.asarray(node_set if node_set is not None else self.ds.test_set)
        accs = []
        base = jax.random.key(cfg.seed + 12345)
        sh = EpochShuffler(nodes, cfg.batch_size, self.plan.num_input_cap[0])
        for seeds, n, step in sh.batches(0):
            key = jax.random.fold_in(base, step)
            batch = self.sample_jit(key, jnp.asarray(seeds), jnp.int32(n))
            if self.feat_on_device:
                feats = device_gather(self.feat_dev, batch.input_nodes)
            else:
                feats = jnp.asarray(
                    host_gather(self.ds.feat, np.asarray(batch.input_nodes),
                                mod=self.ds.feat_mod)
                )
            labels = label_gather(self.label_dev, batch.output_nodes)
            accs.append(float(self.eval_step(self.state.params, batch, feats, labels)))
        return float(np.mean(accs)) if accs else 0.0
