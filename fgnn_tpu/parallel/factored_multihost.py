"""Factored (arch5) training ACROSS HOSTS.

The reference's core contribution is dedicating whole accelerators to
either sampling or training (DistEngine::SampleInit/TrainInit,
dist_engine.cc:231-465; role dispatch operation.cc:343-355). The
single-host ``FactoredEngine`` maps that onto submeshes of one process;
this module maps it onto *processes*: every host is assigned a role, the
sampler host's chips produce batch waves, and the waves cross to the
trainer host(s) over DCN.

Design (jax multi-controller):

* role per PROCESS: processes ``[0, num_sampler_hosts)`` sample, the rest
  train. Each sampler process runs the sample wave jit over its OWN local
  devices (independent sampler workers, like the reference's per-GPU
  sampler processes); trainer processes share one trainer mesh spanning
  all trainer-process devices, so the gradient all-reduce rides the
  intra-host interconnect within a host and the network across hosts.
* wave transport: ``multihost_utils.broadcast_one_to_all(..., is_source=
  sampler_process)`` — a device-fabric collective over the global mesh
  (the DCN analog of the reference's pinned-shared-memory MessageTaskQueue,
  task_queue.cc:66-396; like the reference's ToData/ParseData the batch is
  staged through host memory on each side). Every process participates in
  every wave's broadcast, keeping the collective order globally
  deterministic (no deadlocks).
* init ordering mirrors DistEngine's three phases: every host maps the
  dataset; sampler process 0 presamples and broadcasts the cache ranking
  BEFORE trainer state/cache init (dist_engine.cc:323-344's barrier +
  shared-mmap ranking becomes a broadcast_one_to_all); trainers then build
  the feature cache and model state.
* batch/step/RNG schedule is IDENTICAL to the single-host FactoredEngine
  (same DistShuffler partitioning over S global sampler slots, same
  per-step sample keys, same T-wide group formation and train-key
  ordinals), so a 2-host run reproduces the single-host arch5 losses
  bit-for-bit — tested by tests/test_multihost.py.

Launch (one process per host):

  FGNN_TPU_COORDINATOR=h0:29777 FGNN_TPU_NUM_PROCESSES=2 \
  FGNN_TPU_PROCESS_ID=<i> python examples/train_factored_multihost.py
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CachePolicy, RunConfig
from ..data.schema import Dataset
from ..parallel.shuffler import DistShuffler, EpochShuffler
from ..train.loop import create_train_state
from ..utils import Timer, get_logger
from ..utils.profiler import Profiler
from .factored import FactoredEngine, _put_graph
from .mesh import RoleMesh

log = get_logger(__name__)


def _bcast(tree, src_process: int):
    """Ship a pytree of host arrays from ``src_process`` to every process
    (device-fabric collective over the global mesh). Non-source processes
    must pass a same-shaped skeleton."""
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(
        tree, is_source=jax.process_index() == src_process
    )


def _zeros_like_shape(shapes):
    return jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes
    )


class MultihostFactoredEngine(FactoredEngine):
    """arch5 with host-level roles: sampler host(s) -> DCN -> trainer
    host(s). Subclasses FactoredEngine for the trainer-side machinery
    (_make_train_wave, _feats_for, _run_group); init and the epoch loop
    are role-split."""

    # pylint: disable=super-init-not-called
    def __init__(
        self,
        cfg: RunConfig,
        ds: Dataset,
        num_sampler_hosts: int = 1,
        feat_on_trainer: Optional[bool] = None,
    ):
        cfg.validate()
        assert jax.process_count() > 1, (
            "MultihostFactoredEngine needs jax.distributed (use "
            "FactoredEngine for single-process submesh roles)"
        )
        assert 1 <= num_sampler_hosts < jax.process_count()
        self._setup_common(cfg, ds)
        self.num_sampler_hosts = num_sampler_hosts
        self.proc = jax.process_index()
        self.is_sampler_host = self.proc < num_sampler_hosts
        prof = Profiler.get()
        t0 = Timer()

        # global slot layout: sampler process p owns slots
        # [slot_offset[p], slot_offset[p+1]) — one slot per local device
        all_devs = jax.devices()
        by_proc = [
            [d for d in all_devs if d.process_index == p]
            for p in range(jax.process_count())
        ]
        self.slot_counts = [len(by_proc[p]) for p in range(num_sampler_hosts)]
        self.slot_offset = np.concatenate([[0], np.cumsum(self.slot_counts)])
        S = int(self.slot_offset[-1])                 # global sampler slots
        t_devs = [d for p in range(num_sampler_hosts, jax.process_count())
                  for d in by_proc[p]]
        T = len(t_devs)
        # each sampler PROCESS runs an independent local sampler mesh (the
        # reference's per-GPU sampler workers); trainer mesh spans all
        # trainer-process devices so the grad all-reduce spans hosts
        my_sampler_devs = (by_proc[self.proc] if self.is_sampler_host
                           else by_proc[0])  # placeholder on trainer hosts
        self.roles = RoleMesh(
            sampler_mesh=Mesh(np.array(my_sampler_devs), ("sampler",)),
            trainer_mesh=Mesh(np.array(t_devs), ("data",)),
            num_sampler=S,
            num_trainer=T,
        )
        self._L = (len(by_proc[self.proc]) if self.is_sampler_host else 0)

        # shared step schedule: ALL hosts construct all S shufflers (the
        # permutation is epoch-seeded and identical everywhere,
        # dist_shuffler.cc:112-117)
        seed_cap = self.plan.num_input_cap[0]
        self.shufflers = [
            DistShuffler(ds.train_set, cfg.batch_size, seed_cap, s, S,
                         base_seed=cfg.seed)
            for s in range(S)
        ]
        self.num_step = self.shufflers[0].num_step
        prof.set_num_step(self.num_step)
        self.num_waves = max(sh.num_local_step for sh in self.shufflers)

        # ---- sampler-side init (SampleInit analog) ----------------------
        self.graph_s = None
        self.sample_wave = None
        self.single_sample = None
        if self.is_sampler_host:
            repl_s = NamedSharding(self.roles.sampler_mesh, P())
            shard_s = NamedSharding(self.roles.sampler_mesh, P("sampler"))
            self.graph_s = _put_graph(ds, cfg, repl_s)

            def sample_wave(graph, keys, seeds, nums):
                return jax.vmap(
                    lambda k, s, n: self._sample_one(graph, k, s, n)
                )(keys, seeds, nums)

            self._sample_wave_g = jax.jit(
                sample_wave,
                in_shardings=(repl_s, shard_s, shard_s, shard_s),
                out_shardings=shard_s,
            )
            self.sample_wave = lambda k, s, n: self._sample_wave_g(
                self.graph_s, k, s, n
            )
            _ss = jax.jit(lambda g, k, s, n: self._sample_one(g, k, s, n))
            self.single_sample = lambda k, s, n: _ss(self.graph_s, k, s, n)

        # every host can compute the wave SHAPES without devices (for the
        # broadcast skeletons)
        def _gshapes():
            from ..config import SampleType
            from ..ops.sampling import CSRGraph, INDICES_LANE

            def pad(n):
                return n + ((-n) % INDICES_LANE)

            def tbl(arr, dtype):
                return (jax.ShapeDtypeStruct((pad(ds.num_edge),), dtype)
                        if arr is not None else None)

            st = cfg.sample_type
            ptr_dtype = np.int32 if ds.num_edge < 2**31 else np.int64
            weighted = st in (SampleType.WEIGHTED_KHOP,
                              SampleType.WEIGHTED_KHOP_HASH_DEDUP)
            prefixed = st in (SampleType.WEIGHTED_KHOP_PREFIX,
                              SampleType.WEIGHTED_KHOP_HASH_DEDUP)
            return CSRGraph(
                indptr=jax.ShapeDtypeStruct((ds.num_node + 1,), ptr_dtype),
                indices=jax.ShapeDtypeStruct((pad(ds.num_edge),), np.int32),
                prob_table=(tbl(ds.prob_table, np.float32)
                            if weighted else None),
                alias_table=(tbl(ds.alias_table, np.int32)
                             if weighted else None),
                prob_prefix_table=(
                    tbl(ds.prob_prefix_table, np.float32)
                    if prefixed else None
                ),
            )

        gshapes = _gshapes()

        def _wave_shape(width):
            key_s = jax.ShapeDtypeStruct((width,), jax.random.key(0).dtype)
            seeds_s = jax.ShapeDtypeStruct((width, seed_cap), np.int32)
            nums_s = jax.ShapeDtypeStruct((width,), np.int32)
            return jax.eval_shape(
                lambda g, k, s, n: jax.vmap(
                    lambda kk, ss, nn: self._sample_one(g, kk, ss, nn)
                )(k, s, n),
                gshapes, key_s, seeds_s, nums_s,
            )

        self._wave_shapes = [
            _wave_shape(self.slot_counts[p])
            for p in range(num_sampler_hosts)
        ]
        self._batch_shape = _wave_shape(1)

        # ---- presample BEFORE trainer init (dist_engine.cc:323-344) -----
        self.cache = None
        self.index_wave = None
        ranking = None
        if cfg.use_cache:
            assert cfg.cache_policy in (
                CachePolicy.PRESAMPLE, CachePolicy.DEGREE,
                CachePolicy.DEGREE_HOP, CachePolicy.RANDOM,
                CachePolicy.FAKE_OPTIMAL,
            ), f"unsupported multihost cache policy {cfg.cache_policy}"
            if self.proc == 0:
                boot = EpochShuffler(ds.train_set, cfg.batch_size, seed_cap,
                                     base_seed=cfg.seed)
                c = self._build_cache(self.single_sample, boot)
                ranking = np.asarray(c.ranking, np.int32)
            else:
                ranking = np.zeros(ds.num_node, np.int32)
            ranking = _bcast(ranking, 0)

        # ---- trainer-side init (TrainInit analog) ------------------------
        feat_bytes = ds.feat.shape[0] * ds.feat.shape[1] * 4
        if feat_on_trainer is None:
            feat_on_trainer = not cfg.use_cache and feat_bytes <= (6 << 30)
        self.feat_on_trainer = feat_on_trainer
        self._cur_epoch = 0
        self.feat_t = None
        self.label_t = None
        self.state = None
        self.tx = None
        self.train_wave = None
        self.ckpt = None
        self.start_epoch = 0

        if self.is_sampler_host and cfg.use_cache:
            # sampler keeps only the id->slot table (SampleCacheTableInit,
            # dist_engine.cc:193-229); cache DATA lives with the trainers
            from ..cache.manager import miss_cache_index

            num_cache = int(cfg.cache_percentage * ds.num_node)
            table = np.full((ds.num_node + 1,), -1, np.int32)
            if num_cache:
                table[ranking[:num_cache]] = np.arange(
                    num_cache, dtype=np.int32)
            repl_s = NamedSharding(self.roles.sampler_mesh, P())
            shard_s = NamedSharding(self.roles.sampler_mesh, P("sampler"))
            self._cache_table_s = jax.device_put(table, repl_s)
            self._index_wave_g = jax.jit(
                jax.vmap(miss_cache_index, in_axes=(None, 0)),
                in_shardings=(repl_s, shard_s),
                out_shardings=shard_s,
            )
            self.index_wave = lambda ids: self._index_wave_g(
                self._cache_table_s, ids
            )

        # batch0 for state init comes from sampler process 0 (keeps the
        # init path identical to single-host arch5)
        k0 = jax.random.key(cfg.seed)
        if self.proc == 0:
            boot = EpochShuffler(ds.train_set, cfg.batch_size, seed_cap,
                                 base_seed=cfg.seed)
            seeds0, n0, _ = next(boot.batches(0))
            b0 = self.single_sample(k0, jnp.asarray(seeds0), jnp.int32(n0))
            b0_np = jax.tree.map(np.asarray, b0)
        else:
            b0_np = _zeros_like_shape(
                jax.tree.map(
                    lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                    self._batch_shape,
                )
            )
        b0_np = _bcast(b0_np, 0)

        if not self.is_sampler_host:
            repl_t = self.roles.trainer_replicated
            if cfg.use_cache:
                from ..cache.manager import FeatureCache

                self.cache = FeatureCache(
                    ds.feat, ranking, cfg.cache_percentage, ds.num_node,
                    dtype=(jnp.bfloat16
                           if cfg.compute_dtype == "bfloat16" else None),
                    empty_feat=ds.empty_feat,
                )
            if feat_on_trainer:
                import ml_dtypes

                _fdt = (ml_dtypes.bfloat16
                        if self.compute_dtype is not None else np.float32)
                self.feat_t = jax.device_put(
                    np.asarray(ds.feat).astype(_fdt), repl_t
                )
            self.label_t = jax.device_put(np.asarray(ds.label), repl_t)
            batch0_t = jax.device_put(b0_np, repl_t)
            feats0 = self._feats_for(batch0_t)
            state, self.tx = create_train_state(
                self.model, jax.random.key(cfg.seed + 1), batch0_t, feats0,
                self.dst_caps, lr=cfg.lr, weight_decay=cfg.weight_decay,
            )
            self.state = jax.device_put(state, repl_t)
            self.train_wave = self._make_train_wave(
                repl_t, self.roles.trainer_sharding, self.label_t
            )
            if cfg.ckpt_dir:
                from ..train.checkpoint import CheckpointManager

                self.ckpt = CheckpointManager(cfg.ckpt_dir)
                restored = self.ckpt.restore(self.state)
                if restored is not None:
                    state_h, last_epoch = restored
                    self.state = jax.device_put(state_h, repl_t)
                    self.start_epoch = last_epoch + 1

        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("fgnn-factored-init")
        prof.log_init("init_other", t0.passed())
        log.info(
            "MultihostFactoredEngine proc %d/%d: role=%s, %d sampler slots "
            "on %d host(s) + %d trainer chips, %d steps/epoch, cache=%s",
            self.proc, jax.process_count(),
            "sampler" if self.is_sampler_host else "trainer",
            S, num_sampler_hosts, T, self.num_step,
            f"{cfg.cache_percentage:.0%}" if cfg.use_cache else "off",
        )

    # ------------------------------------------------------------------
    # epoch loop: same schedule as FactoredEngine.run_epoch, role-split
    # ------------------------------------------------------------------
    def run_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self._cur_epoch = epoch
        S = self.roles.num_sampler
        T = self.roles.num_trainer
        t_epoch = Timer()
        base = jax.random.key(cfg.seed)
        prof = Profiler.get()

        # every host walks the same wave schedule; sampler host p fills its
        # own slots, everyone else receives
        iters = [sh.batches(epoch) for sh in self.shufflers]
        pending: deque = deque()
        losses, accs = [], []
        any_overflow = False

        my_lo = int(self.slot_offset[self.proc]) if self.is_sampler_host else 0
        my_hi = (int(self.slot_offset[self.proc + 1])
                 if self.is_sampler_host else 0)

        for wv in range(self.num_waves):
            # -- local slot schedule for every sampler process ------------
            for p in range(self.num_sampler_hosts):
                lo, hi = int(self.slot_offset[p]), int(self.slot_offset[p + 1])
                width = hi - lo
                nums_l, seeds_l, keys_l = [], [], []
                for s in range(lo, hi):
                    # EVERY host advances every slot's iterator — the
                    # schedule (which slots are real, their step ids) is
                    # shared state derived from the epoch-seeded shuffle
                    try:
                        seeds, n, step = next(iters[s])
                    except StopIteration:
                        seeds, n, step = (
                            np.full(self.plan.num_input_cap[0], -1,
                                    np.int32), 0, 0)
                    seeds_l.append(seeds)
                    nums_l.append(np.int32(n))
                    keys_l.append(jax.random.fold_in(
                        base, epoch * self.num_step + step))
                nums_np = np.asarray(nums_l, np.int32)

                if self.is_sampler_host and self.proc == p:
                    wave = self.sample_wave(
                        jnp.stack(keys_l), jnp.asarray(np.stack(seeds_l)),
                        jnp.asarray(nums_np),
                    )
                    idx = (self.index_wave(wave.input_nodes)
                           if self.index_wave is not None else None)
                    wave_np = jax.tree.map(np.asarray, wave)
                    idx_np = (jax.tree.map(np.asarray, idx)
                              if idx is not None else None)
                else:
                    wave_np = _zeros_like_shape(self._wave_shapes[p])
                    idx_np = None
                    if self.index_wave is not None or (
                        cfg.use_cache and not self.is_sampler_host
                    ):
                        idx_np = self._index_skeleton(width)

                # the DCN hand-off (MessageTaskQueue::Send/Recv analog)
                payload = (wave_np, idx_np) if cfg.use_cache else (
                    wave_np, None)
                t = Timer() if self._prof_stages else None
                if cfg.use_cache:
                    wave_np, idx_np = _bcast(payload, p)
                else:
                    wave_np = _bcast(wave_np, p)
                if self._prof_stages:
                    prof.log_epoch_add(epoch, "epoch_copy_time", t.passed())

                if self.is_sampler_host:
                    if self.proc == p:
                        any_overflow |= bool(np.any(wave_np.overflowed))
                    continue
                # trainer: append real batches in global slot order
                for i in range(width):
                    if int(nums_np[i]) <= 0:
                        continue
                    b = jax.tree.map(lambda a: a[i], wave_np)
                    ix = (jax.tree.map(lambda a: a[i], idx_np)
                          if idx_np is not None and cfg.use_cache else None)
                    pending.append((b, ix))
                any_overflow |= bool(np.any(wave_np.overflowed))

            # -- trainer: greedy T-wide groups (same ordinals as
            #    single-host train_group) --------------------------------
            if not self.is_sampler_host:
                while len(pending) >= T:
                    self._mh_train_group(pending, base, losses, accs, T)

        if not self.is_sampler_host:
            while pending:                       # tail (partial group)
                self._mh_train_group(pending, base, losses, accs, T)

        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"fgnn-epoch-{epoch}")
        self._surface_overflow(epoch, any_overflow)
        losses = [float(x) for x in losses]
        accs = [float(x) for x in accs]
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
            "num_step": self.num_step,
            "role": "sampler" if self.is_sampler_host else "trainer",
        }

    def _mh_train_group(self, pending, base, losses, accs, T):
        group = []
        while pending and len(group) < T:
            group.append(pending.popleft())
        # same key ordinal as FactoredEngine.train_group (unpipelined)
        key = jax.random.fold_in(base, 0xD0 + len(losses))
        # batches arrive as host arrays; _prep_group device_puts them to
        # the trainer sharding (the ParseData shm->device step)
        group = [
            (jax.tree.map(jnp.asarray, b),
             jax.tree.map(jnp.asarray, ix) if ix is not None else None)
            for b, ix in group
        ]
        self.state, loss, acc = self._run_group(
            self.state, group, self.train_wave,
            self.roles.trainer_sharding, T, key,
        )
        losses.append(loss)
        accs.append(acc)

    def _index_skeleton(self, width):
        from ..cache.manager import miss_cache_index

        cap = self._batch_shape.input_nodes.shape[-1]
        shp = jax.eval_shape(
            jax.vmap(miss_cache_index, in_axes=(None, 0)),
            jax.ShapeDtypeStruct((self.ds.num_node + 1,), np.int32),
            jax.ShapeDtypeStruct((width, cap), np.int32),
        )
        return _zeros_like_shape(shp)

    def evaluate(self, node_set=None) -> float:
        raise NotImplementedError(
            "evaluate() on the multihost factored engine: run accuracy "
            "reporting from a trainer process with its own sampler, or "
            "use the single-host engine for eval"
        )
