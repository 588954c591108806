"""Asynchronous data-parallel training (arch5 async variant).

Reference: example/samgraph/multi_gpu/async/train_graphsage.py — trainers
skip the per-step DDP all-reduce; each GPU steps a local optimizer and
lazily folds its updates into a shared CPU model (cpu_optimizer.step()).

Design: hogwild-style shared host memory has no device-mesh analog, so
we use the idiomatic equivalent — local SGD with periodic averaging. Each
trainer device holds its own (params, opt_state) replica laid out as a
leading 'data'-sharded axis; the train wave vmaps the whole optimizer step
per replica with NO cross-chip collective. Every ``async_sync_every``
groups a single all-reduce averages the replicas (sync_every=1 degrades to
per-step averaging ~= synchronous DP on the parameter, not gradient,
level). This keeps the reference's property that sampler->trainer batch
flow never stalls on gradient synchronization.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RunConfig
from ..data.schema import Dataset
from ..models import build_model  # noqa: F401  (re-export convenience)
from ..ops.extract import label_gather
from ..train.loop import TrainState, masked_cross_entropy
from ..utils import get_logger
from .factored import FactoredEngine

log = get_logger(__name__)


class AsyncFactoredEngine(FactoredEngine):
    """arch5 with async trainers: per-chip optimizer replicas, periodic
    parameter averaging instead of per-step gradient all-reduce."""

    def __init__(
        self,
        cfg: RunConfig,
        ds: Dataset,
        devices: Optional[Sequence] = None,
        feat_on_trainer: Optional[bool] = None,
    ):
        super().__init__(cfg, ds, devices, feat_on_trainer)
        T = self.roles.num_trainer
        repl_t = self.roles.trainer_replicated
        shard_t = self.roles.trainer_sharding

        # replicate state T-fold along a leading axis sharded over 'data':
        # each trainer chip owns exactly its replica
        def stack_T(x):
            return jnp.broadcast_to(x[None], (T,) + x.shape)

        self.state = jax.device_put(
            jax.tree.map(stack_T, self.state), shard_t
        )
        self.train_wave = self._make_async_wave(shard_t)
        self._sync_wave = jax.jit(
            lambda st: jax.tree.map(
                lambda x: jnp.broadcast_to(
                    jnp.mean(x, axis=0, keepdims=True).astype(x.dtype),
                    x.shape,
                ),
                st,
            ),
            in_shardings=(shard_t,),
            out_shardings=shard_t,
            donate_argnums=(0,),
        )
        self._groups_since_sync = 0
        log.info(
            "AsyncFactoredEngine: %d local replicas, averaging every %d "
            "groups", T, max(1, cfg.async_sync_every),
        )

    def _make_async_wave(self, shard):
        cfg = self.cfg
        B = cfg.batch_size
        model, dst_caps = self.model, self.dst_caps

        def wave(states, label_table, batches, feats, keys):
            # label table is a jit argument (HLO-constant size)
            def one(state, batch, f, k):
                def loss_fn(params):
                    logits = model.apply(
                        {"params": params}, batch, f, dst_caps,
                        deterministic=False, rngs={"dropout": k},
                    )
                    labels = label_gather(label_table, batch.output_nodes)
                    l, a = masked_cross_entropy(logits[:B], labels[:B])
                    return l, a

                (loss, acc), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(state.params)
                updates, new_opt = self.tx.update(
                    grads, state.opt_state, state.params
                )
                new_params = jax.tree.map(lambda p, u: p + u,
                                          state.params, updates)
                return (
                    TrainState(params=new_params, opt_state=new_opt,
                               step=state.step + 1),
                    loss,
                    acc,
                )

            new_states, losses, accs = jax.vmap(one)(
                states, batches, feats, keys
            )
            return new_states, losses.mean(), accs.mean()

        repl = self.roles.trainer_replicated
        wave_g = jax.jit(
            wave,
            in_shardings=(shard, repl, shard, shard, shard),
            out_shardings=(shard, repl, repl),
            donate_argnums=(0,),
        )
        return lambda states, batches, feats, keys: wave_g(
            states, self.label_t, batches, feats, keys
        )

    def _run_group(self, state, group, wave, shard, group_size, key):
        # switcher-style mesh hops are unsupported in async mode; the
        # base class only ever passes self.train_wave here
        state, loss, acc = super()._run_group(
            state, group, self.train_wave, self.roles.trainer_sharding,
            self.roles.num_trainer, key,
        )
        self._groups_since_sync += 1
        if self._groups_since_sync >= max(1, self.cfg.async_sync_every):
            state = self._sync_wave(state)
            self._groups_since_sync = 0
        return state, loss, acc

    def consolidated_state(self) -> TrainState:
        """Replica-averaged state (the reference's shared CPU model)."""
        return jax.tree.map(
            lambda x: jnp.mean(x, axis=0).astype(x.dtype), self.state
        )

    def evaluate(self, node_set=None) -> float:
        """Accuracy of the replica-averaged model — self.state carries a
        leading per-worker axis here, which the base eval step must not
        see (it applies unstacked params)."""
        saved = self.state
        self.state = self.consolidated_state()
        try:
            return super().evaluate(node_set)
        finally:
            self.state = saved
