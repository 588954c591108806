"""Independent DGL-semantics goldens for every conv layer (VERDICT r4 #2).

BASELINE.json targets "per-layer activations allclose vs reference"; the
reference's models are DGL modules:

  * GraphConv norm='both'      — example/samgraph/multi_gpu/train_gcn.py:18-46
  * SAGEConv aggregator='mean' — example/samgraph/multi_gpu/train_graphsage.py
  * WeightedSAGEConv + L2 norm — example/samgraph/balance_switcher/
                                 train_pinsage.py:32-97
  * GATConv (additive attn)    — example/samgraph/train_gat.py

Each golden below is a from-scratch NumPy edge-loop implementation of the
DGL math (per the DGL source semantics the reference relies on), fed random
padded blocks and compared against the model modules' activations in
f32. The goldens (fgnn_tpu/ops/reference_impl.py) share NO code with
fgnn_tpu.models — a silent divergence in aggregation, normalization, or
attention math fails these tests.

DGL semantics pinned here:
  GraphConv norm='both' (dgl/nn/pytorch/conv/graphconv.py):
      feat = X @ W;  feat_src *= outdeg^-1/2 (clamp 1);
      rst = sum over in-edges; rst *= indeg^-1/2 (clamp 1); rst += bias.
  SAGEConv 'mean' (sageconv.py): fc_self(h_dst) + fc_neigh(mean_in(h_src));
      zero-in-degree dst gets a zero neighbor term.
  WeightedSAGEConv (the reference's own module, train_pinsage.py:32-65):
      n = act(Q(h_src)); agg = sum(w*n)/clamp(sum(w),1);
      z = act(W(cat(agg, h_dst))); z /= ||z|| (0-safe).
  GATConv (gatconv.py): feat = X @ W (per head); e = leaky_relu(
      a_l.feat_src + a_r.feat_dst); alpha = softmax over each dst's
      in-edges; out = sum(alpha * feat_src).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fgnn_tpu.models.gnn import (
    GATConv,
    GraphConv,
    GraphSAGE,
    SAGEConv,
    WeightedSAGEConv,
)
from fgnn_tpu.ops.reference_impl import (
    golden_gatconv,
    golden_graphconv,
    golden_sageconv,
    golden_weighted_sage,
)
from fgnn_tpu.ops.sampling import Block, SampledBatch


# ---------------------------------------------------------------------------
# random padded blocks
# ---------------------------------------------------------------------------

def make_block(rng, src_cap, dst_cap, *, regular, K=4, p_valid=0.7,
               with_weights=False, num_dst=None):
    """Random padded COO block; dst-locals < dst_cap, src-locals < src_cap."""
    num_dst = dst_cap if num_dst is None else num_dst
    if regular:
        E_cap = dst_cap * K
        dst = np.repeat(np.arange(dst_cap, dtype=np.int32), K)
        mask = rng.random(E_cap) < p_valid
        mask &= dst < num_dst
    else:
        E_cap = dst_cap * K + 3  # deliberately NOT dst_cap*K => general path
        dst = rng.integers(0, num_dst, E_cap).astype(np.int32)
        mask = rng.random(E_cap) < p_valid
    # give dst 0 zero valid edges to exercise the empty-segment paths
    mask &= dst != 0
    src = rng.integers(0, src_cap, E_cap).astype(np.int32)
    w = rng.random(E_cap).astype(np.float32) + 0.1 if with_weights else None
    return Block(
        src_local=jnp.asarray(np.where(mask, src, -1)),
        dst_local=jnp.asarray(np.where(mask, dst, -1)),
        mask=jnp.asarray(mask),
        num_src=jnp.int32(src_cap),
        num_dst=jnp.int32(num_dst),
        weights=None if w is None else jnp.asarray(w),
        slots_per_dst=K if regular else None,
    )


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.fast
@pytest.mark.parametrize("regular", [True, False])
def test_graphconv_matches_dgl_golden(regular):
    rng = np.random.default_rng(0)
    src_cap, dst_cap = 40, 12
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    m = GraphConv(out_dim=6)
    params = m.init(jax.random.key(1), block, jnp.asarray(h), dst_cap)
    out = np.asarray(m.apply(params, block, jnp.asarray(h), dst_cap))
    W = np.asarray(params["params"]["weight"]["kernel"])
    b = np.asarray(params["params"]["bias"])
    gold = golden_graphconv(block, h, dst_cap, W, b)
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.fast
@pytest.mark.parametrize("regular", [True, False])
def test_sageconv_matches_dgl_golden(regular):
    rng = np.random.default_rng(1)
    src_cap, dst_cap = 37, 11
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    m = SAGEConv(out_dim=5)
    params = m.init(jax.random.key(2), block, jnp.asarray(h), dst_cap)
    out = np.asarray(m.apply(params, block, jnp.asarray(h), dst_cap))
    p = params["params"]
    gold = golden_sageconv(
        block, h, dst_cap,
        np.asarray(p["fc_self"]["kernel"]), np.asarray(p["fc_self"]["bias"]),
        np.asarray(p["fc_neigh"]["kernel"]),
    )
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.fast
@pytest.mark.parametrize("regular", [True, False])
def test_weighted_sage_matches_pinsage_golden(regular):
    rng = np.random.default_rng(2)
    src_cap, dst_cap = 33, 10
    block = make_block(rng, src_cap, dst_cap, regular=regular,
                       with_weights=True)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    m = WeightedSAGEConv(hidden_dim=7, out_dim=6, dropout=0.5)
    params = m.init(jax.random.key(3), block, jnp.asarray(h), dst_cap,
                    deterministic=True)
    out = np.asarray(
        m.apply(params, block, jnp.asarray(h), dst_cap, deterministic=True)
    )
    p = params["params"]
    gold = golden_weighted_sage(
        block, h, dst_cap,
        np.asarray(p["Q"]["kernel"]), np.asarray(p["Q"]["bias"]),
        np.asarray(p["W"]["kernel"]), np.asarray(p["W"]["bias"]),
    )
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.fast
@pytest.mark.parametrize("regular", [True, False])
def test_gatconv_matches_dgl_golden(regular):
    rng = np.random.default_rng(3)
    src_cap, dst_cap = 29, 9
    block = make_block(rng, src_cap, dst_cap, regular=regular)
    h = rng.standard_normal((src_cap, 8)).astype(np.float32)
    m = GATConv(out_dim=4, num_heads=3)
    params = m.init(jax.random.key(4), block, jnp.asarray(h), dst_cap,
                    deterministic=True)
    out = np.asarray(
        m.apply(params, block, jnp.asarray(h), dst_cap, deterministic=True)
    )
    p = params["params"]
    gold = golden_gatconv(
        block, h, dst_cap, np.asarray(p["fc"]["kernel"]),
        np.asarray(p["attn_l"]), np.asarray(p["attn_r"]),
    )
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.fast
def test_sageconv_bf16_tracks_f32_golden():
    """The production compute dtype is bfloat16 (params stay f32); the
    bf16 activations must track the f32 DGL golden within bf16's ~3
    decimal digits."""
    rng = np.random.default_rng(6)
    src_cap, dst_cap = 64, 16
    block = make_block(rng, src_cap, dst_cap, regular=True)
    h = rng.standard_normal((src_cap, 16)).astype(np.float32)
    m = SAGEConv(out_dim=8, dtype=jnp.bfloat16)
    params = m.init(jax.random.key(7), block, jnp.asarray(h), dst_cap)
    out = np.asarray(
        m.apply(params, block, jnp.asarray(h), dst_cap)
    ).astype(np.float32)
    p = params["params"]
    gold = golden_sageconv(
        block, h, dst_cap,
        np.asarray(p["fc_self"]["kernel"]), np.asarray(p["fc_self"]["bias"]),
        np.asarray(p["fc_neigh"]["kernel"]),
    )
    np.testing.assert_allclose(out, gold, rtol=3e-2, atol=3e-2)


@pytest.mark.fast
def test_two_layer_graphsage_model_matches_composed_golden():
    """Whole-model forward (2 layers, deterministic) vs composed goldens:
    pins the layer wiring (block order, relu placement, dst prefixing)."""
    rng = np.random.default_rng(4)
    # layer sizes: input side block0 (src 50 -> dst 20), block1 (20 -> 8)
    b0 = make_block(rng, 50, 20, regular=True, K=3)
    b1 = make_block(rng, 20, 8, regular=False, K=3)
    feats = rng.standard_normal((50, 6)).astype(np.float32)
    batch = SampledBatch(
        blocks=(b0, b1),
        input_nodes=jnp.arange(50, dtype=jnp.int32),
        num_input=jnp.int32(50),
        output_nodes=jnp.arange(8, dtype=jnp.int32),
        num_output=jnp.int32(8),
        overflowed=jnp.zeros((), bool),
    )
    m = GraphSAGE(in_dim=6, hidden_dim=7, num_classes=5, num_layers=2)
    dst_caps = (20, 8)
    params = m.init(jax.random.key(5), batch, jnp.asarray(feats), dst_caps,
                    deterministic=True)
    out = np.asarray(
        m.apply(params, batch, jnp.asarray(feats), dst_caps,
                deterministic=True)
    )
    p = params["params"]
    h1 = golden_sageconv(
        b0, feats, 20,
        np.asarray(p["SAGEConv_0"]["fc_self"]["kernel"]),
        np.asarray(p["SAGEConv_0"]["fc_self"]["bias"]),
        np.asarray(p["SAGEConv_0"]["fc_neigh"]["kernel"]),
    )
    h1 = np.maximum(h1, 0.0)
    gold = golden_sageconv(
        b1, h1.astype(np.float32), 8,
        np.asarray(p["SAGEConv_1"]["fc_self"]["kernel"]),
        np.asarray(p["SAGEConv_1"]["fc_self"]["bias"]),
        np.asarray(p["SAGEConv_1"]["fc_neigh"]["kernel"]),
    )
    np.testing.assert_allclose(out, gold, rtol=1e-4, atol=1e-4)
