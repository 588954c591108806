"""Training step construction.

Replaces the reference's torch training loops (example/samgraph/multi_gpu/
train_*.py:209-416): DGL forward + cross-entropy + Adam + DDP-NCCL
all-reduce become a single jitted optax step whose gradient all-reduce
XLA inserts when the step is jitted over a trainer mesh axis
(parallel.factored).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..ops.sampling import SampledBatch
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray

    @classmethod
    def create(cls, params, tx):
        return cls(params=params, opt_state=tx.init(params), step=jnp.int32(0))


def masked_cross_entropy(
    logits: jnp.ndarray, labels: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean CE over real (label >= 0) rows; also returns accuracy.

    Padded batch tails carry label -1 and are excluded, matching the
    reference's exact-batch semantics (it has no padding; we must mask).
    """
    valid = labels >= 0
    safe = jnp.maximum(labels, 0)
    logits = logits.astype(jnp.float32)  # bf16 compute -> f32 loss
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, safe)
    n = jnp.maximum(jnp.sum(valid), 1)
    loss = jnp.sum(jnp.where(valid, ce, 0.0)) / n
    acc = jnp.sum(jnp.where(valid, jnp.argmax(logits, -1) == safe, False)) / n
    return loss, acc


def create_train_state(
    model,
    rng: jax.Array,
    sample_batch: SampledBatch,
    feats: jnp.ndarray,
    dst_caps,
    lr: float = 0.003,
    weight_decay: float = 0.0,
) -> Tuple[TrainState, optax.GradientTransformation]:
    params = model.init(
        rng, sample_batch, feats, dst_caps, deterministic=True
    )["params"]
    if weight_decay > 0:
        tx = optax.adamw(lr, weight_decay=weight_decay)
    else:
        tx = optax.adam(lr)
    return TrainState.create(params, tx), tx


def make_train_step(
    model,
    tx: optax.GradientTransformation,
    dst_caps,
    batch_size: int,
) -> Callable:
    """Build the (jittable) train step: forward, loss on the seed rows,
    backward, optimizer update. Returns (new_state, loss, acc)."""

    def step(
        state: TrainState,
        batch: SampledBatch,
        feats: jnp.ndarray,
        labels: jnp.ndarray,
        dropout_rng: jax.Array,
    ):
        def loss_fn(params):
            logits = model.apply(
                {"params": params},
                batch,
                feats,
                dst_caps,
                deterministic=False,
                rngs={"dropout": dropout_rng},
            )
            return masked_cross_entropy(logits[:batch_size], labels[:batch_size])

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return (
            TrainState(params=new_params, opt_state=new_opt, step=state.step + 1),
            loss,
            acc,
        )

    return step


def make_eval_step(model, dst_caps, batch_size: int) -> Callable:
    def step(params, batch: SampledBatch, feats, labels):
        logits = model.apply(
            {"params": params}, batch, feats, dst_caps, deterministic=True
        )
        _, acc = masked_cross_entropy(logits[:batch_size], labels[:batch_size])
        return acc

    return step
