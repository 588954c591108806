"""arch7-style app: framework samples, the APP extracts features itself.

Reference: example/samgraph/sgnn_dgl/train_*.py — samgraph does sampling
only; feature extraction happens in torch via ``load_subtensor``
(torch/adapter.py:170-179). Here the app drives fgnn_tpu.session for
sampling and gathers features/labels from arrays it owns, then trains a
GraphSAGE model — demonstrating that the sampler is usable standalone.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

import fgnn_tpu.session as sam
from fgnn_tpu.models import build_model
from fgnn_tpu.train.loop import create_train_state, make_train_step
from fgnn_tpu.utils.logging import log_test_result


def main():
    p = argparse.ArgumentParser("fgnn_tpu arch7 app")
    p.add_argument("--synthetic-nodes", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--fanout", nargs="+", type=int, default=[10, 10])
    args = p.parse_args()

    sam.config(dict(
        dataset="synthetic", model="graphsage", arch="arch7",
        fanout=tuple(args.fanout), batch_size=args.batch_size,
        num_epoch=args.num_epoch, sample_type="khop0", dropout=0.0,
        synthetic_nodes=args.synthetic_nodes,
    ))
    sam.data_init()
    sam.sample_init(0)
    sam.train_init(0)

    ds = sam._session.ds
    eng = sam._session.engine
    # app-owned tensors (the torch side of arch7)
    feat = jnp.asarray(np.asarray(ds.feat))
    label = jnp.asarray(np.asarray(ds.label))

    model = build_model("graphsage", ds.feat_dim, 64, ds.num_class,
                        len(args.fanout), 0.0)
    steps = sam.steps_per_epoch()

    # bootstrap params from one sampled batch
    sam.sample_once()
    key0 = sam.get_next_batch()
    b0 = sam._session._batches[key0]
    f0 = sam.load_subtensor(feat, b0.input_nodes)
    dst_caps = eng.dst_caps
    state, tx = create_train_state(model, jax.random.key(1), b0, f0,
                                   dst_caps, lr=0.01, weight_decay=0.0)
    step_fn = jax.jit(
        make_train_step(model, tx, dst_caps, args.batch_size),
        donate_argnums=(0,),
    )
    sam.release_batch(key0)

    for e in range(args.num_epoch):
        t0 = time.time()
        losses = []
        for s in range(steps):
            sam.sample_once()
            bkey = sam.get_next_batch()
            batch = sam._session._batches[bkey]
            feats = sam.load_subtensor(feat, sam.get_graph_input_nodes(bkey))
            labels = jnp.take(
                label, jnp.maximum(sam.get_graph_output_nodes(bkey), 0)
            )
            state, loss, acc = step_fn(
                state, batch, feats, labels, jax.random.key(e * steps + s)
            )
            losses.append(float(loss))
            sam.release_batch(bkey)
        print(f"Epoch {e:05d} | Time {time.time()-t0:.4f} | "
              f"Loss {np.mean(losses):.4f}")
    log_test_result("epoch_time", f"{time.time()-t0:.4f}")
    sam.shutdown()


if __name__ == "__main__":
    main()
