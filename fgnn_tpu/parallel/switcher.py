"""Balance-switcher engine (arch5 + switcher role).

Reference: example/samgraph/balance_switcher/train_pinsage.py — FGNN's
sampler GPUs finish their per-epoch sampling work early, so once sampling
is done each idle sampler re-registers as a trainer ("switcher") via
``sam.switch_init(worker, ctx, cache_pct)`` (train_pinsage.py:280-309) and
the epoch tail is trained by T+S GPUs, coordinated with forward_barrier
counters (engine.h:69-76).

Design: no process choreography — the epoch driver already
knows when sampling is finished (the wave queue drains), so the tail hook
simply moves the train state onto a second jitted train wave compiled over
the FULL sampler+trainer mesh ('data' axis of size S+T). The gradient
all-reduce spans all devices; the state hops meshes with a single
device_put each way.

How much of the epoch goes to the full mesh is a *scheduling decision the
driver makes up front* (unlike the reference, whose switcher reacts to its
shared-memory queue occupancy — unobservable here because JAX dispatch is
asynchronous): a one-time calibration probe times one sample wave, one
T-wide train group, and one (S+T)-wide train group, then reserves

    K groups  =  total groups  -  (sampling time / T-group time)

for the tail — the number of groups the T-mesh *cannot* finish before the
samplers go idle. Engagement is gated on the measured PER-BATCH cost of a
full-mesh group (see tail_reserve_policy): on real chips the sampler
chips are idle by tail time so the wide group is cheap and the gate
passes; on an oversubscribed virtual mesh it declines rather than
regress.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RunConfig
from ..data.schema import Dataset
from ..utils import Timer, get_logger
from .factored import FactoredEngine

log = get_logger(__name__)


def tail_reserve_policy(
    t_wave: float,
    num_waves: int,
    g_t: float,
    g_full: float,
    T: int,
    W: int,
    num_step: int,
    force: bool = False,
) -> int:
    """Pure scheduling math for the switcher tail (unit-testable).

    Given calibration timings — one sample wave (``t_wave`` x
    ``num_waves`` per epoch), one T-wide train group (``g_t``), one
    W-wide full-mesh train group (``g_full``) — return how many of the
    epoch's ``num_step`` batches to reserve for the full (T+S)-chip tail.

    The reserve is the training backlog the T-mesh cannot clear before
    the samplers go idle: ``K = total_groups - sample_total/g_t`` groups,
    i.e. ``K*T`` batches — engaged only when the full mesh actually pays
    per batch (``g_full/W <= g_t/T``). When training keeps pace (K <= 0)
    a minimal one-group tail still runs on the full mesh if a W-wide
    group is no slower than pushing the same batches through the T-mesh.
    """
    G = -(-num_step // T)                          # total T-groups
    sample_total = t_wave * num_waves
    k = G - int(sample_total / max(g_t, 1e-9))     # backlog groups
    k = max(0, min(k, G))
    per_t, per_full = g_t / T, g_full / W          # per-batch costs

    min_tail = min(W, num_step)
    # The per-batch gate is the primary condition for ANY engagement: on
    # real chips the sampler devices are idle by tail time, so a W-wide
    # group costs about one T-wide group and per_full < per_t; on an
    # OVERSUBSCRIBED virtual mesh "idle" devices still consume host
    # cores, per_full measures worse, and the switch must decline.
    # Round-3 fig17a regression: the old minimal-tail gate compared one
    # wide group against the ceil'd T-group slots it replaces
    # (group-granularity savings) and engaged even though per-batch cost
    # was 25% worse — and wide-group cost degrades far beyond its quiet
    # calibration under load (observed 2.5->7.1s at calibrated 5.3s,
    # while T-groups held 1.7->4.2s), so group-slot math alone is not a
    # safe engagement signal. Both gates must pass.
    backlog_pays = per_full <= per_t * 1.05
    min_tail_pays = (
        backlog_pays and g_full <= (-(-min_tail // T)) * g_t * 1.05
    )
    reserve = 0
    if backlog_pays:
        reserve = k * T
    if reserve == 0 and (min_tail_pays or force):
        reserve = min_tail
    return min(reserve, num_step)


class SwitcherEngine(FactoredEngine):
    """arch5 with ``have_switcher``: sampler chips join training once their
    sampling work for the epoch is done."""

    def __init__(
        self,
        cfg: RunConfig,
        ds: Dataset,
        devices: Optional[Sequence] = None,
        feat_on_trainer: Optional[bool] = None,
    ):
        super().__init__(cfg, ds, devices, feat_on_trainer)
        s_devs = list(self.roles.sampler_mesh.devices.flat)
        t_devs = list(self.roles.trainer_mesh.devices.flat)
        # trainers first so trainer state layouts transfer cheaply
        self.full_mesh = Mesh(np.array(t_devs + s_devs), ("data",))
        self.full_repl = NamedSharding(self.full_mesh, P())
        self.full_shard = NamedSharding(self.full_mesh, P("data"))
        self.num_full = len(t_devs) + len(s_devs)

        self.label_full = jax.device_put(np.asarray(ds.label), self.full_repl)
        # the switcher's own feature residency: the reference gives the
        # switcher GPU a separately-sized cache built from the SAME
        # ranking (sam.switch_init(..., cache_percentage),
        # train_pinsage.py:309; DoSwitchCacheFeatureCopy). Tail groups
        # recompute their miss split against this cache — the shipped
        # sampler-side index was classified against the trainer cache.
        self.switch_cache = None
        if self.cache is not None and cfg.switch_cache_percentage > 0:
            from ..cache.manager import FeatureCache

            self.switch_cache = FeatureCache(
                self.cache.feat_host,
                self.cache.ranking,
                cfg.switch_cache_percentage,
                ds.num_node,
                dtype=self.cache.dtype,
            )
        self.train_wave_full = self._make_train_wave(
            self.full_repl, self.full_shard, self.label_full
        )
        log.info(
            "SwitcherEngine: epoch tail trains on %d chips (%d trainers + "
            "%d switchers)", self.num_full, len(t_devs), len(s_devs),
        )

    _in_tail = False
    _tail_reserve_batches: Optional[int] = None

    # ------------------------------------------------------------------
    # tail sizing
    # ------------------------------------------------------------------
    def _calibrate_tail_reserve(self) -> int:
        """One-time probe: time one sample wave, one T-group, one full
        group; reserve the training backlog the T-mesh can't clear before
        sampling ends. Probe train waves run on a copied state (the wave
        donates its arg) with a key never used by real training."""
        cfg = self.cfg
        S, T = self.roles.num_sampler, self.roles.num_trainer
        W = self.num_full
        base = jax.random.key(cfg.seed ^ 0xCA11B)
        seeds, n, _ = next(iter(self.shufflers[0].batches(0)))
        keys = jnp.stack([jax.random.fold_in(base, i) for i in range(S)])
        seeds_w = jnp.asarray(np.stack([seeds] * S))
        nums_w = jnp.asarray(np.stack([np.int32(n)] * S))

        def one_wave():
            w = self.sample_wave(keys, seeds_w, nums_w)
            ix = (self.index_wave(w.input_nodes)
                  if self.index_wave is not None else None)
            jax.block_until_ready(ix if ix is not None else w.num_input)
            return w, ix

        one_wave()                      # compile
        t_wave = float("inf")
        for _ in range(3):              # min-of-reps (one noisy timing
            t = Timer()                 # mis-reserves every epoch)
            wave, idx = one_wave()
            t_wave = min(t_wave, t.passed())

        wave_t = jax.device_put(wave, self.roles.trainer_replicated)
        idx_t = (jax.device_put(idx, self.roles.trainer_replicated)
                 if idx is not None else None)
        batches = []
        for i in range(max(T, W)):
            b = jax.tree.map(lambda a: a[i % S], wave_t)
            ix = (jax.tree.map(lambda a: a[i % S], idx_t)
                  if idx_t is not None else None)
            batches.append((b, ix))

        def time_group(group, wave_fn, shard, width):
            probe = jax.tree.map(jnp.copy, self.state)  # donation-safe
            out = self._run_group(probe, group, wave_fn, shard, width,
                                  jax.random.fold_in(base, 0xBEEF))
            jax.block_until_ready(out[1])
            best = float("inf")
            for _ in range(3):          # min-of-reps (ADVICE r2): a GC
                tt = Timer()            # pause in ONE probe would size
                probe = jax.tree.map(   # the tail for every epoch
                    jnp.copy, self.state)
                out = self._run_group(probe, group, wave_fn, shard, width,
                                      jax.random.fold_in(base, 0xBEEF))
                jax.block_until_ready(out[1])
                best = min(best, tt.passed())
            return best

        g_t = time_group(batches[:T], self.train_wave,
                         self.roles.trainer_sharding, T)
        self._in_tail = True
        try:
            g_full = time_group(batches[:W], self.train_wave_full,
                                self.full_shard, W)
        finally:
            self._in_tail = False

        num_waves = max(sh.num_local_step for sh in self.shufflers)

        # Engage only when the measured full mesh actually pays. On real
        # chips the sampler chips are idle by tail time, so a W-wide group
        # costs about one T-wide group (g_full ~= g_t) and both gates
        # pass; on an OVERSUBSCRIBED virtual mesh (8 devices on 4 cores)
        # "idle" chips still consume host cores, g_full measures slower,
        # and the switcher declines rather than regress — the reference's
        # queue-reactive switcher has the same property (it only grabs
        # work an idle GPU can absorb). FGNN_TPU_SWITCHER_FORCE=1
        # overrides for mechanics demonstrations.
        import os as _os

        force = _os.environ.get("FGNN_TPU_SWITCHER_FORCE", "") not in (
            "", "0", "false")
        reserve = tail_reserve_policy(
            t_wave, num_waves, g_t, g_full, T, W, self.num_step,
            force=force,
        )
        log.info(
            "switcher calibration: wave %.4fs x%d, T-group %.4fs x%d, "
            "full-group %.4fs -> reserve %d of %d batches for the tail%s",
            t_wave, num_waves, g_t, -(-self.num_step // T), g_full,
            reserve, self.num_step,
            " (declined: full mesh measured slower per batch)"
            if reserve == 0 else "",
        )
        return reserve

    def _main_loop_may_train(self, consumed: int) -> bool:
        if self._tail_reserve_batches is None:
            return True
        return consumed < self.num_step - self._tail_reserve_batches

    def run_epoch(self, epoch: int) -> dict:
        if self._tail_reserve_batches is None:
            self._tail_reserve_batches = self._calibrate_tail_reserve()
        return super().run_epoch(epoch)

    def _feats_for(self, batch_t, index=None):
        if self._in_tail and self.switch_cache is not None:
            # tail groups include switcher chips whose cache is sized by
            # switch_cache_percentage — reclassify against it (the shipped
            # index was computed for the trainer cache)
            import jax.numpy as jnp

            ids = np.asarray(batch_t.input_nodes)
            idx = self.switch_cache.get_miss_cache_index(jnp.asarray(ids))
            miss_t, _ = self.switch_cache.upload_miss(idx)
            return self.switch_cache.combine(idx, miss_t)
        return super()._feats_for(batch_t, index)

    def _train_tail(self, pending_batches, base, losses, accs):
        if not pending_batches:
            return
        if not self._tail_reserve_batches:
            # calibration declined the full mesh (it measured slower per
            # batch) — leftover partial groups stay on the T mesh too,
            # otherwise every epoch still pays one wide-collective group
            return super()._train_tail(pending_batches, base, losses, accs)
        W = self.num_full
        n_tail = len(pending_batches)
        state_full = jax.device_put(self.state, self.full_repl)
        self._in_tail = True
        try:
            groups = []
            while pending_batches:
                group = []
                while pending_batches and len(group) < W:
                    group.append(pending_batches.popleft())
                groups.append(group)
            if (
                self.cfg.pipeline
                and (not self.feat_on_trainer)
                and not self._prof_stages
            ):
                # pipeline the tail's host miss gathers like the main
                # loop: prep group k+1 under the full-mesh wave of k
                pool = self._prep_pool()
                futs = [
                    (
                        pool.submit(self._prep_group, g, W, self.full_shard),
                        jax.random.fold_in(base, 0xD0 + len(losses) + i),
                    )
                    for i, g in enumerate(groups)
                ]
                for fut, key in futs:
                    stacked, feats = fut.result()
                    keys = jax.random.split(key, W)
                    state_full, loss, acc = self.train_wave_full(
                        state_full, stacked, feats, keys
                    )
                    losses.append(loss)
                    accs.append(acc)
            else:
                for group in groups:
                    key = jax.random.fold_in(base, 0xD0 + len(losses))
                    state_full, loss, acc = self._run_group(
                        state_full, group, self.train_wave_full,
                        self.full_shard, W, key,
                    )
                    losses.append(loss)
                    accs.append(acc)
        finally:
            self._in_tail = False
        self.state = jax.device_put(state_full, self.roles.trainer_replicated)
        log.debug("switcher tail: trained %d batches on %d chips", n_tail, W)
