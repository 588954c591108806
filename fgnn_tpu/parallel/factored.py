"""Factored multi-chip engines.

FactoredEngine = arch5 (FGNN proper, dist_engine.cc + dist_loops_arch5.cc):
dedicated sampler chips produce batches in SPMD waves; batches cross to the
trainer submesh (a device-to-device device_put — the MemoryQueue analog);
trainer chips run data-parallel training with gradient all-reduce over the 'data'
mesh axis (replacing torch DDP/NCCL, train_gcn.py:223-242).

SGNNEngine = arch6 (the T_SOTA space-shared baseline,
dist_loops_arch6.cc): every chip samples AND trains its own batch inside
one fused SPMD step.

Pipelining: instead of background threads + bounded TaskQueues
(cuda_loops_arch*.cc), we exploit JAX's async dispatch — sample waves are
launched ahead of consumption up to ``max_copying_jobs`` in-flight waves,
giving the same sample/train overlap with no threads.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..cache.manager import FeatureCache
from ..cache.presample import presample_ranking
from ..cache.policy import build_ranking
from ..config import CachePolicy, RunConfig, SampleType
from ..data.schema import Dataset
from ..models import build_model
from ..ops.extract import device_gather, label_gather, mock_gather


def _pick_feat_gather(ds):
    """Modulo indexing when the dataset declares empty-feat mock mode
    (GPUMockExtract, cuda_extraction.cu:51-72)."""
    return mock_gather if ds.empty_feat else device_gather
from ..ops.padding import make_plan
from ..ops.random_walk import random_walk_topk
from ..ops.reference_impl import calibrate_caps
from ..ops.sampling import CSRGraph, multi_layer_sample
from ..parallel.mesh import make_data_mesh, make_role_mesh
from ..placement import feat_budget, features_fit
from ..parallel.shuffler import (
    AlignedDistShuffler,
    DistShuffler,
    EpochShuffler,
)
from ..train.loop import (
    TrainState,
    create_train_state,
    make_eval_step,
    masked_cross_entropy,
)
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler

log = get_logger(__name__)


def _put_graph(ds: Dataset, cfg: RunConfig, sharding) -> CSRGraph:
    from ..ops.sampling import INDICES_LANE

    if ds.num_edge >= 2**31 and not jax.config.jax_enable_x64:
        raise ValueError(
            f"graph has {ds.num_edge} >= 2^31 edges; int64 indptr requires "
            "jax_enable_x64 (see OneChipEngine)"
        )
    ptr_dtype = np.int32 if ds.num_edge < 2**31 else np.int64
    def put(x, dtype=None):
        a = np.asarray(x)
        if dtype is not None:
            a = a.astype(dtype)
        if a.ndim == 1 and len(a) == ds.num_edge:
            # lane-align per-edge arrays for blocked 1D gathers
            rem = (-len(a)) % INDICES_LANE
            if rem:
                a = np.pad(a, (0, rem))
        return jax.device_put(a, sharding)
    weighted = cfg.sample_type in (
        SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_HASH_DEDUP
    )
    return CSRGraph(
        indptr=put(ds.indptr, ptr_dtype),
        indices=put(ds.indices),
        prob_table=put(ds.prob_table) if weighted and ds.prob_table is not None else None,
        alias_table=put(ds.alias_table) if weighted and ds.alias_table is not None else None,
        prob_prefix_table=(
            put(ds.prob_prefix_table)
            if cfg.sample_type in (
                SampleType.WEIGHTED_KHOP_PREFIX,
                # hash-dedup's Gumbel branch needs exact weights
                SampleType.WEIGHTED_KHOP_HASH_DEDUP,
            )
            and ds.prob_prefix_table is not None
            else None
        ),
    )


class _EngineBase:
    """Shared setup: plan calibration, sampler closure, model."""

    def _setup_common(self, cfg: RunConfig, ds: Dataset):
        self.cfg = cfg
        self.ds = ds
        # profile_level >= 2: per-stage timers, forcing a sync at each
        # stage boundary (the reference's per-op cuda-event timing,
        # cuda_loops.cc:238-264, costs the same overlap). Level 1 keeps
        # async dispatch and reports only wall-clock epoch time.
        # per-stage timing at profile_level>=2; trace mode also needs the
        # stepwise path (the scanned epoch program is trace-blind)
        self._prof_stages = (cfg.profile_level >= 2
                             or Profiler.get().trace_enabled)
        # cfg-requested detail unlocks the matching log_step gates even
        # when FGNN_TPU_PROFILE_LEVEL wasn't exported (library users)
        Profiler.get().level = max(Profiler.get().level, cfg.profile_level)
        indptr = np.asarray(ds.indptr)
        if cfg.sample_type == SampleType.RANDOM_WALK:
            fan_sampling = [cfg.num_neighbor] * cfg.num_layer_rw
        else:
            fan_sampling = list(reversed(cfg.fanout))
        caps = calibrate_caps(
            indptr, np.asarray(ds.indices), np.asarray(ds.train_set),
            cfg.batch_size, fan_sampling, seed=cfg.seed,
            replace=(cfg.sample_type == SampleType.KHOP1),
        )
        self.plan = make_plan(
            cfg.batch_size, list(reversed(fan_sampling)), ds.num_node,
            unique_caps=caps,
        )
        self.dst_caps = tuple(reversed(self.plan.num_input_cap))
        self.compute_dtype = (
            jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        )
        self.model = build_model(
            cfg.model, ds.feat_dim, cfg.num_hidden, ds.num_class,
            self.plan.num_layer, cfg.dropout, dtype=self.compute_dtype,
        )

    def _sample_one(self, graph, key, seeds, num_seeds,
                    dedup_last_hop: bool = True):
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
            with_out_degrees=cfg.model == "gcn",
        )

    def _surface_overflow(self, epoch: int, overflowed: bool):
        """Warn (or raise under sanity mode) when any sampled batch clipped
        its calibrated caps — silent truncation corrupts gradients."""
        if not overflowed:
            return
        Profiler.get().log_epoch_add(epoch, "epoch_cap_overflow", 1.0)
        msg = (
            f"epoch {epoch}: sampler cap overflow — a batch exceeded "
            f"unique/edge caps {self.plan.num_unique_cap}/"
            f"{self.plan.num_edge_cap} and was clipped"
        )
        if self.cfg.sanity_check:
            raise RuntimeError(msg)
        log.warning(msg)

    def _build_cache(self, sample_fn, shuffler) -> Optional[FeatureCache]:
        cfg = self.cfg
        if not cfg.use_cache:
            return None
        if cfg.cache_policy == CachePolicy.PRESAMPLE_STATIC:
            from ..cache.presample import presample_static_ranking

            ranking = presample_static_ranking(
                sample_fn, shuffler, np.asarray(self.ds.indptr),
                np.asarray(self.ds.indices), self.ds.num_node,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
            )
        elif cfg.cache_policy == CachePolicy.PRESAMPLE:
            ranking = presample_ranking(
                sample_fn, shuffler, self.ds.num_node,
                presample_epoch=cfg.presample_epoch, seed=cfg.seed,
            )
        else:
            ranking = build_ranking(self.ds, cfg.cache_policy, cfg.seed)
        return FeatureCache(
            self.ds.feat, ranking, cfg.cache_percentage, self.ds.num_node,
            dtype=(jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                   else None),
            empty_feat=self.ds.empty_feat,
        )


class FactoredEngine(_EngineBase):
    """arch5: S sampler chips + T trainer chips."""

    # phase-1 training pace: how many T-wide groups to consume per drained
    # sample wave. None = greedy (plain arch5). The switcher sets 1 so the
    # backlog that would sit in the reference's global queue flows to the
    # enlarged tail group instead.
    max_groups_per_drain = None

    def __init__(
        self,
        cfg: RunConfig,
        ds: Dataset,
        devices: Optional[Sequence] = None,
        feat_on_trainer: Optional[bool] = None,
    ):
        cfg.validate()
        self._setup_common(cfg, ds)
        S, T = cfg.num_sample_worker, cfg.num_train_worker
        self.roles = make_role_mesh(S, T, devices)
        prof = Profiler.get()
        t0 = Timer()
        copy_s = 0.0  # device-placement spans (SampleDataCopy analog)

        # --- sampler side (SampleInit analog, dist_engine.cc:231-364) ----
        t_copy = Timer()
        self.graph_s = _put_graph(ds, cfg, self.roles.sampler_replicated)
        jax.block_until_ready(self.graph_s.indices)
        copy_s += t_copy.passed()

        def sample_wave(graph, keys, seeds, nums):
            # vmapped over the sampler axis: one batch per sampler chip.
            # `graph` is a jit ARGUMENT — closing over the device CSR
            # would embed it as an HLO constant (compile-size blowup).
            return jax.vmap(
                lambda k, s, n: self._sample_one(graph, k, s, n)
            )(keys, seeds, nums)

        shard_s = self.roles.sampler_sharding
        repl_s = self.roles.sampler_replicated
        self._sample_wave_g = jax.jit(
            sample_wave,
            in_shardings=(repl_s, shard_s, shard_s, shard_s),
            out_shardings=shard_s,
        )
        self.sample_wave = lambda keys, seeds, nums: self._sample_wave_g(
            self.graph_s, keys, seeds, nums
        )

        # shufflers: contiguous step ranges per sampler (dist_shuffler.cc)
        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            DistShuffler(ds.train_set, cfg.batch_size, seed_cap, s, S,
                         base_seed=cfg.seed)
            for s in range(S)
        ]
        self.num_step = self.shufflers[0].num_step
        prof.set_num_step(self.num_step)

        # presample runs on sampler chip 0 before trainers init
        # (dist_engine.cc:323-344 ordering), with its OWN full-train-set
        # shuffler (dist/pre_sampler.cc:39-53) — worker 0's step range can
        # be empty when steps < samplers
        _ss = jax.jit(lambda g, k, s, n: self._sample_one(g, k, s, n))
        single_sample = lambda k, s, n: _ss(self.graph_s, k, s, n)
        boot_shuffler = EpochShuffler(
            ds.train_set, cfg.batch_size, seed_cap, base_seed=cfg.seed
        )
        self.single_sample = single_sample
        self.cache = self._build_cache(single_sample, boot_shuffler)

        # sampler-side miss/cache split (DoGetCacheMissIndex,
        # dist_loops.cc:271-323): the cache table lives with the samplers;
        # only the index lists cross to the trainers
        self.index_wave = None
        if self.cache is not None:
            from ..cache.manager import miss_cache_index

            self._cache_table_s = jax.device_put(
                np.asarray(self.cache.cache_table), repl_s
            )
            self._index_wave_g = jax.jit(
                jax.vmap(miss_cache_index, in_axes=(None, 0)),
                in_shardings=(repl_s, shard_s),
                out_shardings=shard_s,
            )
            self.index_wave = lambda ids: self._index_wave_g(
                self._cache_table_s, ids
            )

        # --- trainer side (TrainInit analog, dist_engine.cc:366-465) -----
        feat_bytes = (ds.feat.shape[0] * ds.feat.shape[1]
                      * (2 if self.compute_dtype is not None else 4))
        if feat_on_trainer is None:
            budget = feat_budget(0, self.roles.trainer_mesh.devices.flat[0])
            feat_on_trainer = (not cfg.use_cache
                               and features_fit(feat_bytes, budget))
        self.feat_on_trainer = feat_on_trainer
        repl_t = self.roles.trainer_replicated
        shard_t = self.roles.trainer_sharding
        t_copy = Timer()
        if feat_on_trainer:
            import ml_dtypes

            _fdt = (ml_dtypes.bfloat16 if self.compute_dtype is not None
                    else np.float32)
            self.feat_t = jax.device_put(
                np.asarray(ds.feat).astype(_fdt), repl_t
            )
        else:
            self.feat_t = None
            if self.cache is not None:
                self.cache_data_t = jax.device_put(
                    np.asarray(self.cache.cache_data), repl_t
                )
        self.label_t = jax.device_put(np.asarray(ds.label), repl_t)
        jax.block_until_ready(self.label_t)
        copy_s += t_copy.passed()

        # init params on trainer mesh
        self._cur_epoch = 0
        k0 = jax.random.key(cfg.seed)
        seeds0, n0, _ = next(boot_shuffler.batches(0))
        batch0 = single_sample(k0, jnp.asarray(seeds0), jnp.int32(n0))
        batch0_t = jax.device_put(batch0, repl_t)
        feats0 = self._feats_for(batch0_t)
        state, self.tx = create_train_state(
            self.model, jax.random.key(cfg.seed + 1), batch0_t, feats0,
            self.dst_caps, lr=cfg.lr, weight_decay=cfg.weight_decay,
        )
        self.state = jax.device_put(state, repl_t)

        # --- the DP train wave -------------------------------------------
        self.train_wave = self._make_train_wave(repl_t, shard_t, self.label_t)

        # --- checkpoint/resume (reference has none) ----------------------
        self.ckpt = None
        self.start_epoch = 0
        if cfg.ckpt_dir:
            from ..train.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(cfg.ckpt_dir)
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                state_h, last_epoch = restored
                self.state = jax.device_put(state_h, repl_t)
                self.start_epoch = last_epoch + 1
        prof.log_init("init_copy", copy_s)
        prof.log_init("init_other", max(0.0, t0.passed() - copy_s))
        log.info(
            "FactoredEngine: %d samplers + %d trainers, %d steps/epoch, "
            "cache=%s feat_on_trainer=%s",
            S, T, self.num_step,
            f"{cfg.cache_percentage:.0%}" if self.cache else "off",
            feat_on_trainer,
        )

    # ------------------------------------------------------------------
    def _make_train_wave(self, repl, shard, label_table):
        """Build the jitted data-parallel train wave for a trainer group.

        batches/feats/keys have a leading group dim sharded over 'data';
        the mean over that axis gives DDP-style grad all-reduce
        (train_gcn.py:223-242 analog; XLA emits the all-reduce, NCCL on
        GPUs).
        Parametrized by shardings so the switcher can build a second wave
        over the enlarged sampler+trainer mesh. The label table enters as
        a jit argument (not a closure constant — HLO size).
        """
        cfg = self.cfg
        B = cfg.batch_size
        model, dst_caps = self.model, self.dst_caps

        def train_wave(state, label_tab, batches, feats, keys):
            def loss_fn(params):
                def one(batch, f, k):
                    logits = model.apply(
                        {"params": params}, batch, f, dst_caps,
                        deterministic=False, rngs={"dropout": k},
                    )
                    labels = label_gather(label_tab, batch.output_nodes)
                    l, a = masked_cross_entropy(logits[:B], labels[:B])
                    w = (batch.num_output > 0).astype(jnp.float32)
                    return l * w, a * w, w

                ls, accs, ws = jax.vmap(one)(batches, feats, keys)
                wsum = jnp.maximum(ws.sum(), 1.0)
                return ls.sum() / wsum, accs.sum() / wsum

            (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params
            )
            updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
            new_params = jax.tree.map(
                lambda p, u: p + u, state.params, updates
            )
            return (
                TrainState(params=new_params, opt_state=new_opt,
                           step=state.step + 1),
                loss,
                acc,
            )

        wave_g = jax.jit(
            train_wave,
            in_shardings=(repl, repl, shard, shard, shard),
            out_shardings=(repl, repl, repl),
            donate_argnums=(0,),
        )
        return lambda state, batches, feats, keys: wave_g(
            state, label_table, batches, feats, keys
        )

    def _feats_for(self, batch_t, index=None):
        """Feature extraction on the trainer side for one batch (already on
        trainer mesh). `index` is the sampler-computed miss/cache split
        (DoGetCacheMissIndex) when available."""
        if self.feat_on_trainer:
            return _pick_feat_gather(self.ds)(self.feat_t,
                                              batch_t.input_nodes)
        assert self.cache is not None, (
            "host-resident features require a cache in factored mode"
        )
        # trainer-side miss handling (DoCacheFeatureCopy analog)
        if index is None:
            ids = np.asarray(batch_t.input_nodes)
            index = self.cache.get_miss_cache_index(jnp.asarray(ids))
        miss_t, num_miss = self.cache.upload_miss(
            index, device=self.roles.trainer_replicated
        )
        prof = Profiler.get()
        itm = miss_t.dtype.itemsize
        prof.log_epoch_add(self._cur_epoch, "epoch_miss_bytes",
                           float(num_miss * miss_t.shape[1] * itm))
        prof.log_epoch_add(
            self._cur_epoch, "epoch_feature_bytes",
            float(int(batch_t.num_input) * miss_t.shape[1] * itm),
        )
        return self.cache.combine(index, miss_t)

    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self._cur_epoch = epoch
        S, T = self.roles.num_sampler, self.roles.num_trainer
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        repl_t = self.roles.trainer_replicated
        prof = Profiler.get()
        prof_stages = self._prof_stages

        iters = [sh.batches(epoch) for sh in self.shufflers]
        live = list(range(S))
        pending_batches: deque = deque()
        in_flight: deque = deque()
        losses, accs = [], []
        wave_ovfs = []

        def launch_wave():
            nonlocal live
            seeds_l, nums_l, keys_l = [], [], []
            for s in list(live):
                try:
                    seeds, n, step = next(iters[s])
                except StopIteration:
                    live.remove(s)
                    continue
                seeds_l.append(seeds)
                nums_l.append(np.int32(n))
                keys_l.append(
                    jax.random.fold_in(base, epoch * self.num_step + step)
                )
            if not seeds_l:
                return False
            while len(seeds_l) < S:  # pad wave (dead sampler slots)
                seeds_l.append(np.full_like(seeds_l[0], -1))
                nums_l.append(np.int32(0))
                keys_l.append(jax.random.fold_in(base, 0x7FFFFFFF))
            t = Timer() if prof_stages else None
            wave = self.sample_wave(
                jnp.stack(keys_l), jnp.asarray(np.stack(seeds_l)),
                jnp.asarray(np.stack(nums_l)),
            )
            # sampler-side miss/cache split ships WITH the batch
            idx = (self.index_wave(wave.input_nodes)
                   if self.index_wave is not None else None)
            if prof_stages:
                jax.block_until_ready(idx if idx is not None else wave.num_input)
                prof.log_epoch_add(epoch, "epoch_sample_time", t.passed())
                if prof.trace_enabled:
                    prof.trace_event(len(wave_ovfs) + len(in_flight),
                                     "kL1Event_Sample", t._start * 1e6,
                                     Timer.now_us())
            in_flight.append(
                (wave, idx, len([1 for n in nums_l if int(n) > 0]))
            )
            return True

        def drain_wave():
            wave, idx, n_real = in_flight.popleft()
            wave_ovfs.append(wave.overflowed)  # [S] bool, fetched at epoch end
            # cross the sampler->trainer boundary (the "global queue"):
            # one device-to-device transfer of the whole wave
            t = Timer() if prof_stages else None
            wave_t = jax.device_put(wave, repl_t)
            idx_t = jax.device_put(idx, repl_t) if idx is not None else None
            if prof_stages:
                jax.block_until_ready(wave_t.num_input)
                prof.log_epoch_add(epoch, "epoch_copy_time", t.passed())
                # DoGraphCopy analog, keyed by wave ordinal within the epoch
                prof.log_step(prof.step_key(epoch, len(wave_ovfs) - 1),
                              "L2_graph_copy_time", t.passed())
                if prof.trace_enabled:
                    prof.trace_event(len(wave_ovfs), "kL2Event_Copy_Graph",
                                     t._start * 1e6, Timer.now_us())
            for i in range(n_real):
                b = jax.tree.map(lambda a: a[i], wave_t)
                ix = (jax.tree.map(lambda a: a[i], idx_t)
                      if idx_t is not None else None)
                pending_batches.append((b, ix))

        shard_t = self.roles.trainer_sharding

        # 2-stage group pipeline (dist_loops_arch5.cc:106-147 PIPELINE
        # analog): host miss-gather + staging of group k+1 overlaps the
        # trainer wave of group k. Only worth a thread when features are
        # host-resident (cache mode); stage-profiled runs stay serial so
        # the timers mean what they say.
        pipelined = (
            cfg.pipeline and (not self.feat_on_trainer) and not prof_stages
        )
        prep_pool = self._prep_pool() if pipelined else None
        prep_futs: deque = deque()

        def drain_preps(block: bool):
            while prep_futs and (
                block or len(prep_futs) > 1 or prep_futs[0][0].done()
            ):
                fut, key = prep_futs.popleft()
                stacked, feats = fut.result()
                keys = jax.random.split(key, T)
                self.state, loss, acc = self.train_wave(
                    self.state, stacked, feats, keys
                )
                losses.append(loss)
                accs.append(acc)

        consumed = [0]  # real batches trained by the main (T-mesh) loop

        def train_group():
            group = []
            while pending_batches and len(group) < T:
                group.append(pending_batches.popleft())
            consumed[0] += len(group)
            key = jax.random.fold_in(base, 0xD0 + len(losses) + len(prep_futs))
            if prep_pool is None:
                self.state, loss, acc = self._run_group(
                    self.state, group, self.train_wave, shard_t, T, key
                )
                losses.append(loss)
                accs.append(acc)
            else:
                prep_futs.append((
                    prep_pool.submit(self._prep_group, group, T, shard_t),
                    key,
                ))
                drain_preps(block=False)

        depth = max(1, cfg.max_copying_jobs)
        more = True
        while more or in_flight:
            while more and len(in_flight) < depth:
                more = launch_wave()
            if in_flight:
                drain_wave()
            groups = 0
            while (
                len(pending_batches) >= T
                and (
                    self.max_groups_per_drain is None
                    or groups < self.max_groups_per_drain
                )
                and self._main_loop_may_train(consumed[0])
            ):
                train_group()
                groups += 1
        drain_preps(block=True)  # state order: pipelined groups before tail
        # tail phase: sampling is finished, sampler chips idle — the
        # switcher subclass enlarges the trainer group here
        self._train_tail(pending_batches, base, losses, accs)

        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
        if wave_ovfs:
            self._surface_overflow(
                epoch, bool(np.any(np.asarray(jnp.stack(wave_ovfs))))
            )
        epoch_time = t_epoch.passed()
        Profiler.get().log_epoch_add(epoch, "epoch_total_time", epoch_time)
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
            "num_step": self.num_step,
        }

    def _main_loop_may_train(self, consumed: int) -> bool:
        """Hook: may the main loop keep forming T-wide groups? The
        switcher subclass reserves the epoch's last batches for the
        enlarged (sampler+trainer) tail mesh."""
        return True

    def _prep_pool(self):
        """Single-worker executor for the group-prep stage (order is the
        pipeline's correctness invariant: one worker ⇒ FIFO completion)."""
        if getattr(self, "_prep_pool_obj", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prep_pool_obj = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fgnn-prep"
            )
        return self._prep_pool_obj

    def _prep_group(self, group, group_size, shard):
        """Stage one trainer group: pad, stack, extract features (host
        miss gather when cached), commit to the trainer sharding. Runs on
        the prep thread in pipelined mode."""
        group = list(group)
        while len(group) < group_size:
            group.append(group[0])
        batches = [b for b, _ix in group]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)
        feats = jnp.stack([self._feats_for(b, ix) for b, ix in group])
        stacked = jax.device_put(stacked, shard)
        feats = jax.device_put(feats, shard)
        return stacked, feats

    def _run_group(self, state, group, wave, shard, group_size, key):
        """Pad a batch group to `group_size`, shard it over the wave's
        'data' axis, and run one train wave.

        Partial groups pad by repeating (dummy repeats carry weight w>0 —
        zeroing their loss weight would undercount; repeating a real batch
        only reweights it slightly, matching the reference's aligned-step
        padding semantics)."""
        assert group, "empty train group"
        prof_stages = self._prof_stages
        prof = Profiler.get() if prof_stages else None
        t = Timer() if prof_stages else None
        # committed args must match the jit's in_shardings exactly
        stacked, feats = self._prep_group(group, group_size, shard)
        if prof_stages:
            jax.block_until_ready(feats)
            prof.log_epoch_add(self._cur_epoch, "epoch_extract_time",
                               t.passed())
            if prof.trace_enabled:
                prof.trace_event(int(state.step), "kL1Event_Copy",
                                 t._start * 1e6, Timer.now_us())
            t.reset()
        keys = jax.random.split(key, group_size)
        out = wave(state, stacked, feats, keys)
        if prof_stages:
            jax.block_until_ready(out[1])  # loss scalar
            prof.log_epoch_add(self._cur_epoch, "epoch_train_time",
                               t.passed())
            if prof.trace_enabled:
                prof.trace_event(int(out[0].step), "kL1Event_Train",
                                 t._start * 1e6, Timer.now_us())
        return out

    def evaluate(self, node_set: Optional[np.ndarray] = None) -> float:
        """Test accuracy on the trainer mesh (train_accuracy.py analog):
        sample on the sampler side, extract+eval on the trainer side."""
        cfg = self.cfg
        nodes = np.asarray(
            node_set if node_set is not None else self.ds.test_set
        )
        if not hasattr(self, "_eval_step"):
            self._eval_step = jax.jit(
                make_eval_step(self.model, self.dst_caps, cfg.batch_size)
            )
        shuffler = EpochShuffler(
            nodes, cfg.batch_size, self.plan.num_input_cap[0],
            base_seed=cfg.seed + 7,
        )
        repl_t = self.roles.trainer_replicated
        base = jax.random.key(cfg.seed + 12345)
        accs = []
        for seeds, n, step in shuffler.batches(0):
            key = jax.random.fold_in(base, step)
            batch = self.single_sample(key, jnp.asarray(seeds), jnp.int32(n))
            b = jax.device_put(batch, repl_t)
            feats = self._feats_for(b)
            labels = label_gather(self.label_t, b.output_nodes)
            accs.append(float(
                self._eval_step(self.state.params, b, feats, labels)
            ))
        return float(np.mean(accs)) if accs else 0.0

    def _train_tail(self, pending_batches, base, losses, accs):
        """Train whatever remains after sampling finished; the plain
        factored engine keeps the T-wide trainer group."""
        T = self.roles.num_trainer
        shard_t = self.roles.trainer_sharding
        while pending_batches:
            group = []
            while pending_batches and len(group) < T:
                group.append(pending_batches.popleft())
            key = jax.random.fold_in(base, 0xD0 + len(losses))
            self.state, loss, acc = self._run_group(
                self.state, group, self.train_wave, shard_t, T, key
            )
            losses.append(loss)
            accs.append(acc)


class SGNNEngine(_EngineBase):
    """arch6: every chip samples + extracts + trains (space-shared)."""

    def __init__(self, cfg: RunConfig, ds: Dataset,
                 devices: Optional[Sequence] = None):
        cfg.validate()
        self._setup_common(cfg, ds)
        W = cfg.num_train_worker
        self.mesh = make_data_mesh(W, devices)
        repl = NamedSharding(self.mesh, P())
        shard = NamedSharding(self.mesh, P("data"))
        self.repl, self.shard = repl, shard

        self.graph = _put_graph(ds, cfg, repl)
        import ml_dtypes

        _fdt = (ml_dtypes.bfloat16 if self.compute_dtype is not None
                else np.float32)
        self.feat_dev = jax.device_put(np.asarray(ds.feat).astype(_fdt), repl)
        self.label_dev = jax.device_put(np.asarray(ds.label), repl)

        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            AlignedDistShuffler(ds.train_set, cfg.batch_size, seed_cap, w, W,
                                base_seed=cfg.seed)
            for w in range(W)
        ]
        self.num_local_step = self.shufflers[0].num_local_step
        Profiler.get().set_num_step(self.num_local_step * W)

        # init
        _ss = jax.jit(lambda g, k, s, n: self._sample_one(g, k, s, n))
        single_sample = lambda k, s, n: _ss(self.graph, k, s, n)
        self.single_sample = single_sample
        seeds0, n0, _ = next(self.shufflers[0].batches(0))
        batch0 = single_sample(
            jax.random.key(cfg.seed), jnp.asarray(seeds0), jnp.int32(n0)
        )
        _fg = _pick_feat_gather(ds)
        feats0 = _fg(self.feat_dev, batch0.input_nodes)
        state, self.tx = create_train_state(
            self.model, jax.random.key(cfg.seed + 1), batch0, feats0,
            self.dst_caps, lr=cfg.lr, weight_decay=cfg.weight_decay,
        )
        self.state = jax.device_put(state, repl)

        B = cfg.batch_size
        model, dst_caps = self.model, self.dst_caps

        # features are chip-resident in SGNN -> last-hop dedup is a net
        # loss (see multi_layer_sample docstring); GCN keeps dedup (its
        # out-degree normalization is not duplicate-invariant)
        dedup = cfg.model == "gcn"
        self._dedup = dedup

        def fused_wave(state, graph, feat, label, keys, seeds, nums):
            # graph/feat/label are jit ARGUMENTS (HLO-constant blowup
            # otherwise — the feature matrix alone is 100s of MB)
            def loss_fn(params):
                def one(k, s, n):
                    batch = self._sample_one(graph, k, s, n,
                                             dedup_last_hop=dedup)
                    feats = _fg(feat, batch.input_nodes)
                    labels = label_gather(label, batch.output_nodes)
                    logits = model.apply(
                        {"params": params}, batch, feats, dst_caps,
                        deterministic=False,
                        rngs={"dropout": jax.random.fold_in(k, 7)},
                    )
                    l, a = masked_cross_entropy(logits[:B], labels[:B])
                    w = (n > 0).astype(jnp.float32)
                    return l * w, a * w, w, batch.overflowed

                ls, accs, ws, ovfs = jax.vmap(one)(keys, seeds, nums)
                wsum = jnp.maximum(ws.sum(), 1.0)
                return ls.sum() / wsum, (accs.sum() / wsum, ovfs.any())

            (loss, (acc, ovf)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
            new_params = jax.tree.map(lambda p, u: p + u, state.params, updates)
            return (
                TrainState(params=new_params, opt_state=new_opt,
                           step=state.step + 1),
                loss,
                acc,
                ovf,
            )

        self._fused_wave_g = jax.jit(
            fused_wave,
            in_shardings=(repl, repl, repl, repl, shard, shard, shard),
            out_shardings=(repl, repl, repl, repl),
            donate_argnums=(0,),
        )
        self.fused_wave = lambda state, keys, seeds, nums: self._fused_wave_g(
            state, self.graph, self.feat_dev, self.label_dev,
            keys, seeds, nums,
        )

        # whole-epoch program: scan the fused wave over local steps — one
        # dispatch + one stats fetch per epoch (cf. OneChipEngine)
        def epoch_fused(state, graph, feat, label, keys_all, seeds_all,
                        nums_all):
            def body(st, inp):
                keys, seeds, nums = inp
                st, loss, acc, ovf = fused_wave(
                    st, graph, feat, label, keys, seeds, nums
                )
                return st, (loss, acc, ovf)

            state, (losses, accs, ovfs) = jax.lax.scan(
                body, state, (keys_all, seeds_all, nums_all)
            )
            return state, losses.mean(), accs.mean(), ovfs.any()

        # leading scan axis replicated; per-wave axis sharded over 'data'
        def seq(s):
            return NamedSharding(self.mesh, P(None, *s.spec))

        self._epoch_wave_g = jax.jit(
            epoch_fused,
            in_shardings=(repl, repl, repl, repl, seq(shard), seq(shard),
                          seq(shard)),
            out_shardings=(repl, repl, repl, repl),
            donate_argnums=(0,),
        )
        self.epoch_wave = (
            lambda state, keys_all, seeds_all, nums_all: self._epoch_wave_g(
                state, self.graph, self.feat_dev, self.label_dev,
                keys_all, seeds_all, nums_all,
            )
        )
        # --- checkpoint/resume (parity with OneChip/Factored engines) -----
        self.ckpt = None
        self.start_epoch = 0
        if cfg.ckpt_dir:
            from ..train.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(cfg.ckpt_dir)
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                state_h, last_epoch = restored
                self.state = jax.device_put(state_h, repl)
                self.start_epoch = last_epoch + 1
        log.info("SGNNEngine: %d workers, %d local steps/epoch", W,
                 self.num_local_step)

    def _build_profile_fns(self):
        """De-fused sample / extract / train waves for profile_level>=2.

        The production path is ONE fused scanned program (no internal
        stage boundaries exist at runtime); stage timing requires running
        the equivalent de-fused program — the standard profiling-mode
        overhead tradeoff. RNG key folding matches the fused wave, so the
        training math is step-for-step identical."""
        cfg = self.cfg
        repl, shard = self.repl, self.shard
        B = cfg.batch_size
        model, dst_caps = self.model, self.dst_caps
        dedup = self._dedup

        def sample_wave(graph, keys, seeds, nums):
            return jax.vmap(
                lambda k, s, n: self._sample_one(graph, k, s, n,
                                                 dedup_last_hop=dedup)
            )(keys, seeds, nums)

        self._p_sample_g = jax.jit(
            sample_wave, in_shardings=(repl, shard, shard, shard),
            out_shardings=shard,
        )

        _fgw = _pick_feat_gather(self.ds)

        def gather_wave(feat, ids):
            return jax.vmap(lambda i: _fgw(feat, i))(ids)

        self._p_gather_g = jax.jit(
            gather_wave, in_shardings=(repl, shard), out_shardings=shard,
        )

        def train_wave(state, label, batches, feats, keys, nums):
            def loss_fn(params):
                def one(batch, f, k, n):
                    labels = label_gather(label, batch.output_nodes)
                    logits = model.apply(
                        {"params": params}, batch, f, dst_caps,
                        deterministic=False,
                        rngs={"dropout": jax.random.fold_in(k, 7)},
                    )
                    l, a = masked_cross_entropy(logits[:B], labels[:B])
                    w = (n > 0).astype(jnp.float32)
                    return l * w, a * w, w

                ls, accs, ws = jax.vmap(one)(batches, feats, keys, nums)
                wsum = jnp.maximum(ws.sum(), 1.0)
                return ls.sum() / wsum, accs.sum() / wsum

            (loss, acc), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            updates, new_opt = self.tx.update(
                grads, state.opt_state, state.params
            )
            new_params = jax.tree.map(
                lambda p, u: p + u, state.params, updates
            )
            return (
                TrainState(params=new_params, opt_state=new_opt,
                           step=state.step + 1),
                loss,
                acc,
            )

        self._p_train_g = jax.jit(
            train_wave,
            in_shardings=(repl, repl, shard, shard, shard, shard),
            out_shardings=(repl, repl, repl),
            donate_argnums=(0,),
        )

    def _run_epoch_profiled(self, epoch: int) -> dict:
        """Stepwise epoch with per-stage timers (profile_level >= 2)."""
        cfg = self.cfg
        W = len(self.shufflers)
        prof = Profiler.get()
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        if not hasattr(self, "_p_sample_g"):
            self._build_profile_fns()
        L = self.num_local_step
        cap = self.plan.num_input_cap[0]
        losses, accs, ovfs = [], [], []
        rows = [list(sh.batches(epoch)) for sh in self.shufflers]
        for local in range(L):
            seeds = np.full((W, cap), -1, dtype=np.int32)
            nums = np.zeros((W,), dtype=np.int32)
            for w in range(W):
                if local < len(rows[w]):
                    s, n, _ = rows[w][local]
                    seeds[w], nums[w] = s, n
            keys = jnp.stack([
                jax.random.fold_in(base, epoch * 100003 + local * W + w)
                for w in range(W)
            ])
            t = Timer()
            wave = self._p_sample_g(
                self.graph, keys, jnp.asarray(seeds), jnp.asarray(nums)
            )
            jax.block_until_ready(wave.num_input)
            prof.log_epoch_add(epoch, "epoch_sample_time", t.passed())
            skey = prof.step_key(epoch, local)
            prof.log_step(skey, "L1_sample_time", t.passed())
            if prof.trace_enabled:
                prof.trace_event(skey, "kL1Event_Sample", t._start * 1e6,
                                 Timer.now_us())
            ovfs.append(wave.overflowed)
            t.reset()
            feats = self._p_gather_g(self.feat_dev, wave.input_nodes)
            jax.block_until_ready(feats)
            prof.log_epoch_add(epoch, "epoch_extract_time", t.passed())
            prof.log_step(skey, "L1_copy_time", t.passed())
            if prof.trace_enabled:
                prof.trace_event(skey, "kL1Event_Copy", t._start * 1e6,
                                 Timer.now_us())
            t.reset()
            self.state, loss, acc = self._p_train_g(
                self.state, self.label_dev, wave, feats, keys,
                jnp.asarray(nums),
            )
            jax.block_until_ready(loss)
            prof.log_epoch_add(epoch, "epoch_train_time", t.passed())
            prof.log_step(skey, "L1_train_time", t.passed())
            if prof.trace_enabled:
                prof.trace_event(skey, "kL1Event_Train", t._start * 1e6,
                                 Timer.now_us())
            losses.append(float(loss))
            accs.append(float(acc))
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
            "num_step": self.num_local_step * W,
        }

    def evaluate(self, node_set: Optional[np.ndarray] = None) -> float:
        """Test accuracy on the data mesh (train_accuracy.py analog)."""
        cfg = self.cfg
        nodes = np.asarray(
            node_set if node_set is not None else self.ds.test_set
        )
        if not hasattr(self, "_eval_step"):
            self._eval_step = jax.jit(
                make_eval_step(self.model, self.dst_caps, cfg.batch_size)
            )
        _fg = _pick_feat_gather(self.ds)
        base = jax.random.key(cfg.seed + 12345)
        sh = EpochShuffler(nodes, cfg.batch_size, self.plan.num_input_cap[0],
                           base_seed=cfg.seed + 7)
        accs = []
        for seeds, n, step in sh.batches(0):
            key = jax.random.fold_in(base, step)
            batch = self.single_sample(key, jnp.asarray(seeds), jnp.int32(n))
            feats = _fg(self.feat_dev, batch.input_nodes)
            labels = label_gather(self.label_dev, batch.output_nodes)
            accs.append(float(
                self._eval_step(self.state.params, batch, feats, labels)
            ))
        return float(np.mean(accs)) if accs else 0.0

    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        if self._prof_stages:
            return self._run_epoch_profiled(epoch)
        W = len(self.shufflers)
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        # assemble the whole epoch host-side: [L, W, cap] seeds, [L, W]
        # nums/keys — a single upload + one scanned device program
        L = self.num_local_step
        seeds_all = np.full(
            (L, W, self.plan.num_input_cap[0]), -1, dtype=np.int32
        )
        nums_all = np.zeros((L, W), dtype=np.int32)
        keys_l = []
        for w, sh in enumerate(self.shufflers):
            for local, (seeds, n, step) in enumerate(sh.batches(epoch)):
                seeds_all[local, w] = seeds
                nums_all[local, w] = n
        key_rows = [
            jnp.stack([
                jax.random.fold_in(base, epoch * 100003 + local * W + w)
                for w in range(W)
            ])
            for local in range(L)
        ]
        self.state, loss, acc, ovf = self.epoch_wave(
            self.state,
            jnp.stack(key_rows),
            jnp.asarray(seeds_all),
            jnp.asarray(nums_all),
        )
        stats = np.asarray(jnp.stack(
            [loss, acc, ovf.astype(jnp.float32)]
        ))  # one fetch
        losses, accs = [float(stats[0])], [float(stats[1])]
        self._surface_overflow(epoch, stats[2] > 0)
        epoch_time = t_epoch.passed()
        Profiler.get().log_epoch_add(epoch, "epoch_total_time", epoch_time)
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
            "num_step": self.num_local_step * W,
        }
