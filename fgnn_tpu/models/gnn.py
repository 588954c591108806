"""GNN model zoo — plain parameter pytrees over padded COO blocks.

Parity targets (reference model definitions):
  * GCN: stack of DGL GraphConv, ReLU, dropout between layers
    (example/samgraph/multi_gpu/train_gcn.py:18-46).
  * GraphSAGE: mean-aggregator SAGEConv stack
    (example/samgraph/multi_gpu/train_graphsage.py).
  * PinSAGE: WeightedSAGEConv with random-walk visit counts as edge
    weights and L2-normalized output
    (example/samgraph/balance_switcher/train_pinsage.py:32-97).
  * GAT: multi-head GATConv stack, ELU (example/samgraph/train_gat.py).

Each layer consumes one sampled Block (input-side first, matching DGL block
order, torch/adapter.py:99-118) and the full src-space feature matrix
``h`` [src_cap, D]; destination features are the prefix ``h[:dst_cap]``
(seeds-first invariant of the sampler's renumbering).

Every module is a frozen dataclass of hyperparameters with
``init(rng, *inputs) -> {"params": tree}`` and
``apply({"params": tree}, *inputs, deterministic=..., rngs={"dropout": k})``.
Parameters are float32 (dense kernels lecun-normal, biases zero, attention
vectors glorot-uniform); ``dtype`` sets the compute dtype, to which inputs
and dense parameters are cast before each product.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.sampling import Block, SampledBatch
from .aggregate import (
    gather_src,
    in_degrees,
    out_degrees,
    segment_agg,
    segment_softmax,
)

_lecun_normal = jax.nn.initializers.lecun_normal()
_glorot_uniform = jax.nn.initializers.glorot_uniform()


def _dense_params(key, in_dim: int, out_dim: int, use_bias: bool = True):
    p = {"kernel": _lecun_normal(key, (in_dim, out_dim), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_dim,), jnp.float32)
    return p


def _dense(p, x, dtype):
    """x @ kernel + bias, with x and the parameters cast to ``dtype``
    (None: their common promoted type)."""
    kernel, bias = p["kernel"], p.get("bias")
    if dtype is None:
        dtype = jnp.result_type(x, kernel)
    y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    if bias is not None:
        y = y + jnp.reshape(bias.astype(dtype), (1,) * (y.ndim - 1) + (-1,))
    return y


class _Dropout:
    """Inverted dropout with a fresh key per call site (folded from one
    base key in trace order, so a step's masks are a function of its
    key alone)."""

    def __init__(self, rng, deterministic: bool):
        self.rng = rng
        self.deterministic = deterministic
        self.calls = 0

    def __call__(self, x, rate: float):
        if self.deterministic or rate == 0.0:
            return x
        if self.rng is None:
            raise ValueError(
                "dropout with deterministic=False needs rngs={'dropout': key}"
            )
        key = jax.random.fold_in(self.rng, self.calls)
        self.calls += 1
        if rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - rate
        mask = jax.random.bernoulli(key, keep, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))


class _Module:
    """init/apply entry points over ``init_params`` and ``forward``."""

    def init(self, rng, *inputs, deterministic: bool = True):
        """``inputs`` as for ``apply``; the second one (the layer's ``h``
        or the model's ``feats``) gives the input width."""
        return {"params": self.init_params(rng, inputs[1].shape[-1])}

    def apply(self, variables, *inputs, deterministic: bool = True,
              rngs: Optional[dict] = None):
        drop = _Dropout((rngs or {}).get("dropout"), deterministic)
        return self.forward(variables["params"], *inputs, drop=drop)


@dataclasses.dataclass(frozen=True)
class GraphConv(_Module):
    """DGL GraphConv, norm='both', allow_zero_in_degree."""

    out_dim: int
    activation: Optional[Callable] = None
    dtype: Optional[Any] = None

    def init_params(self, key, in_dim: int):
        return {
            "weight": _dense_params(key, in_dim, self.out_dim,
                                    use_bias=False),
            "bias": jnp.zeros((self.out_dim,), jnp.float32),
        }

    def forward(self, p, block: Block, h: jnp.ndarray, dst_cap: int, *,
                drop: _Dropout) -> jnp.ndarray:
        src_cap = h.shape[0]
        h = _dense(p["weight"], h, self.dtype)
        deg_out = out_degrees(block, src_cap)
        h = h * jax.lax.rsqrt(jnp.maximum(deg_out, 1.0))[:, None]
        msgs = gather_src(h, block)
        agg = segment_agg(msgs, block, dst_cap, mode="sum")
        deg_in = in_degrees(block, dst_cap)
        agg = agg * jax.lax.rsqrt(jnp.maximum(deg_in, 1.0))[:, None]
        agg = agg + p["bias"]
        if self.activation is not None:
            agg = self.activation(agg)
        return agg


@dataclasses.dataclass(frozen=True)
class SAGEConv(_Module):
    """DGL SAGEConv with 'mean' aggregator."""

    out_dim: int
    activation: Optional[Callable] = None
    dtype: Optional[Any] = None

    def init_params(self, key, in_dim: int):
        k1, k2 = jax.random.split(key)
        return {
            "fc_self": _dense_params(k1, in_dim, self.out_dim),
            "fc_neigh": _dense_params(k2, in_dim, self.out_dim,
                                      use_bias=False),
        }

    def forward(self, p, block: Block, h: jnp.ndarray, dst_cap: int, *,
                drop: _Dropout) -> jnp.ndarray:
        h_dst = h[:dst_cap]
        msgs = gather_src(h, block)
        agg = segment_agg(msgs, block, dst_cap, mode="mean")
        out = (_dense(p["fc_self"], h_dst, self.dtype)
               + _dense(p["fc_neigh"], agg, self.dtype))
        if self.activation is not None:
            out = self.activation(out)
        return out


@dataclasses.dataclass(frozen=True)
class WeightedSAGEConv(_Module):
    """PinSAGE conv (balance_switcher/train_pinsage.py:32-65)."""

    hidden_dim: int
    out_dim: int
    dropout: float = 0.5
    activation: Callable = jax.nn.relu
    dtype: Optional[Any] = None

    def init_params(self, key, in_dim: int):
        k1, k2 = jax.random.split(key)
        return {
            "Q": _dense_params(k1, in_dim, self.hidden_dim),
            "W": _dense_params(k2, self.hidden_dim + in_dim, self.out_dim),
        }

    def forward(self, p, block: Block, h: jnp.ndarray, dst_cap: int, *,
                drop: _Dropout) -> jnp.ndarray:
        if block.weights is None:
            raise ValueError("PinSAGE requires edge weights")
        h_dst = h[:dst_cap]
        n = self.activation(_dense(p["Q"], drop(h, self.dropout), self.dtype))
        msgs = gather_src(n, block)
        agg = segment_agg(
            msgs, block, dst_cap, mode="weighted_mean", edge_weights=block.weights
        )
        z = self.activation(_dense(
            p["W"], drop(jnp.concatenate([agg, h_dst], axis=1), self.dropout),
            self.dtype,
        ))
        z_norm = jnp.linalg.norm(z, axis=1, keepdims=True)
        z_norm = jnp.where(z_norm == 0.0, 1.0, z_norm)
        return z / z_norm


@dataclasses.dataclass(frozen=True)
class GATConv(_Module):
    """DGL GATConv: multi-head additive attention."""

    out_dim: int
    num_heads: int
    attn_drop: float = 0.0
    negative_slope: float = 0.2
    activation: Optional[Callable] = None
    dtype: Optional[Any] = None

    def init_params(self, key, in_dim: int):
        k1, k2, k3 = jax.random.split(key, 3)
        H, D = self.num_heads, self.out_dim
        return {
            "fc": _dense_params(k1, in_dim, H * D, use_bias=False),
            "attn_l": _glorot_uniform(k2, (1, H, D), jnp.float32),
            "attn_r": _glorot_uniform(k3, (1, H, D), jnp.float32),
        }

    def forward(self, p, block: Block, h: jnp.ndarray, dst_cap: int, *,
                drop: _Dropout) -> jnp.ndarray:
        H, D = self.num_heads, self.out_dim
        feat = _dense(p["fc"], h, self.dtype).reshape(-1, H, D)
        el = jnp.sum(feat * p["attn_l"], axis=-1)  # [src_cap, H]
        er = jnp.sum(feat * p["attn_r"], axis=-1)
        src = jnp.maximum(block.src_local, 0)
        dstl = jnp.maximum(block.dst_local, 0)
        e = jax.nn.leaky_relu(
            el[src] + er[:dst_cap][jnp.minimum(dstl, dst_cap - 1)],
            self.negative_slope,
        )  # [E_cap, H]
        alpha = segment_softmax(e, block, dst_cap)
        alpha = drop(alpha, self.attn_drop)
        msgs = feat[src] * alpha[:, :, None]  # [E_cap, H, D]
        out = segment_agg(
            msgs.reshape(msgs.shape[0], H * D), block, dst_cap, mode="sum"
        ).reshape(dst_cap, H, D)
        if self.activation is not None:
            out = self.activation(out)
        return out


# ---------------------------------------------------------------------------
# Full models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Stack(_Module):
    """A model as a stack of convs, one per sampled block, input side
    first; parameters live under ``<ConvClass>_<i>`` keys. Subclasses
    list their convs in ``convs()`` and say where the stack drops its
    layers' inputs (``input_dropout``): "between" layers (GCN,
    GraphSAGE), before "every" layer (GAT) or "none" (PinSAGE's convs
    drop inside). Multi-head outputs are concatenated into the next
    layer and averaged after the last."""

    in_dim: int
    hidden_dim: int
    num_classes: int
    num_layers: int
    dropout: float = 0.5
    dtype: Optional[Any] = None

    input_dropout = "between"

    def _out_dims(self):
        """(out_dim, is_last) per layer."""
        return [(self.num_classes if i == self.num_layers - 1
                 else self.hidden_dim, i == self.num_layers - 1)
                for i in range(self.num_layers)]

    def _named_convs(self):
        return [(f"{type(c).__name__}_{i}", c)
                for i, c in enumerate(self.convs())]

    def init_params(self, key, in_dim: int):
        keys = jax.random.split(key, self.num_layers)
        params = {}
        for k, (name, conv) in zip(keys, self._named_convs()):
            params[name] = conv.init_params(k, in_dim)
            in_dim = conv.out_dim * getattr(conv, "num_heads", 1)
        return params

    def forward(self, p, batch: SampledBatch, feats, dst_caps, *, drop):
        h = feats if self.dtype is None else feats.astype(self.dtype)
        for i, (name, conv) in enumerate(self._named_convs()):
            if self.input_dropout == "every" or (
                    self.input_dropout == "between" and i > 0):
                h = drop(h, self.dropout)
            h = conv.forward(p[name], batch.blocks[i], h, dst_caps[i],
                             drop=drop)
            if h.ndim == 3:
                h = (h.mean(axis=1) if i == self.num_layers - 1
                     else h.reshape(h.shape[0], -1))
        return h


class GCN(_Stack):
    def convs(self):
        return [GraphConv(d, activation=None if last else jax.nn.relu,
                          dtype=self.dtype) for d, last in self._out_dims()]


class GraphSAGE(_Stack):
    def convs(self):
        return [SAGEConv(d, activation=None if last else jax.nn.relu,
                         dtype=self.dtype) for d, last in self._out_dims()]


class PinSAGE(_Stack):
    input_dropout = "none"

    def convs(self):
        return [WeightedSAGEConv(self.hidden_dim, d, self.dropout,
                                 dtype=self.dtype)
                for d, _ in self._out_dims()]


@dataclasses.dataclass(frozen=True)
class GAT(_Stack):
    dropout: float = 0.6
    num_heads: int = 8
    num_out_heads: int = 1
    attn_drop: float = 0.6

    input_dropout = "every"

    def convs(self):
        return [GATConv(d, self.num_out_heads if last else self.num_heads,
                        attn_drop=self.attn_drop,
                        activation=None if last else jax.nn.elu,
                        dtype=self.dtype) for d, last in self._out_dims()]


def build_model(name: str, in_dim: int, hidden: int, num_classes: int,
                num_layers: int, dropout: float = 0.5,
                dtype=None) -> _Module:
    """dtype: compute dtype (e.g. jnp.bfloat16) — params stay float32,
    activations/matmuls run in `dtype`."""
    name = name.lower()
    if name == "gcn":
        return GCN(in_dim, hidden, num_classes, num_layers, dropout,
                   dtype=dtype)
    if name in ("graphsage", "sage"):
        return GraphSAGE(in_dim, hidden, num_classes, num_layers, dropout,
                         dtype=dtype)
    if name == "pinsage":
        return PinSAGE(in_dim, hidden, num_classes, num_layers, dropout,
                       dtype=dtype)
    if name == "gat":
        return GAT(in_dim, hidden, num_classes, num_layers, dropout=dropout,
                   dtype=dtype)
    raise ValueError(f"unknown model {name}")
