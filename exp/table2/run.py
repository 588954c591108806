"""Table 2 analog: epoch-to-epoch node-access similarity — the *why* of
presampling-based caching.

Reference: exp/table2 (readme.md:29-41) — `node_access:epoch_similarity`
per (sample_type, app): the hot set barely changes across epochs, so one
presampled epoch predicts the rest.

We run the real sampler for --num-epoch epochs per workload, log the
touched-node set per epoch, and report the mean pairwise-consecutive
similarity (profiler.node_access_similarity, the ReportNodeAccess analog,
profiler.cc:657-791).

Usage: python exp/table2/run.py [--synthetic-nodes N] [--cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fgnn_tpu.config import RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.data.synthetic import build_alias_tables
    from fgnn_tpu.engine import OneChipEngine

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=32,
        num_class=16, seed=0, neighbor_skew=args.neighbor_skew,
    )
    build_alias_tables(ds, seed=0)  # weighted variants need prob tables

    workloads = [
        ("khop2", "gcn", SampleType.KHOP2, dict(fanout=(5, 10, 15))),
        ("random_walk", "pinsage", SampleType.RANDOM_WALK,
         dict(fanout=(5, 10, 15))),
        ("weighted_khop_prefix", "gcn", SampleType.WEIGHTED_KHOP_PREFIX,
         dict(fanout=(5, 10, 15))),
    ]

    rows = []
    for st_name, app, st, kw in workloads:
        cfg = RunConfig(model=app, batch_size=args.batch_size,
                        num_hidden=32, sample_type=st, **kw)
        eng = OneChipEngine(cfg, ds)
        base = jax.random.key(7)
        epoch_sets = []
        for ep in range(args.num_epoch):
            touched = set()
            for seeds, n, step in eng.shuffler.batches(ep):
                b = eng.sample_jit(
                    jax.random.fold_in(base, ep * 65537 + step),
                    jnp.asarray(seeds), jnp.int32(n),
                )
                ids = np.asarray(b.input_nodes)
                touched.update(ids[ids >= 0].tolist())
            epoch_sets.append(touched)
        sims = []
        for a, b_ in zip(epoch_sets, epoch_sets[1:]):
            inter = len(a & b_)
            union = len(a | b_)
            sims.append(100.0 * inter / max(union, 1))
        sim = float(np.mean(sims)) if sims else 0.0
        print(f"[table2] {st_name:24s} {app:10s} "
              f"epoch_similarity={sim:.2f}%", flush=True)
        rows.append(dict(sample_type=st_name, app=app,
                         epoch_similarity=sim,
                         epochs=args.num_epoch,
                         touched_per_epoch=[len(s) for s in epoch_sets]))

    with open(os.path.join(HERE, "table2.dat"), "w") as f:
        f.write("sample_type\tapp\tnode_access:epoch_similarity\n")
        for r in rows:
            f.write(f"{r['sample_type']}\t{r['app']}\t"
                    f"{r['epoch_similarity']:.4f}\n")
    with open(os.path.join(HERE, "table2.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(f"[table2] wrote {HERE}/table2.dat")


if __name__ == "__main__":
    main()
