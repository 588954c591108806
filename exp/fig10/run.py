"""Figure 10 analog: cache hit rate vs cache policy x percentage.

Reference: exp/fig10 — random/degree/presample/optimal hit rates per
workload. We measure real hit rates by running the factored engine with
host-resident features and each policy, sweeping cache percentage.

NOTE on magnitudes: papers100M-like 90%+ hit rates require the batch
receptive field to be SELECTIVE (a ~500K-node frontier inside a 111M-node
graph dominated by hubs). On small smoke graphs the 2-hop frontier covers
most of the graph, so hit rate degenerates toward the cache fraction for
every policy — compare policies RELATIVELY (presample tracks optimal) and
use >=1M nodes for absolute numbers.
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
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.01, 0.05, 0.1, 0.2])
    p.add_argument("--policies", nargs="+",
                   default=["random", "degree", "pre_sample"])
    p.add_argument("--neighbor-skew", type=float, default=6.0,
               help="access skew (6 ~ papers100M-like hot set)")
    p.add_argument("--neighbor-pref", type=float, default=0.5,
               help="fraction of edge mass riding the out-degree ranking "
                    "(0.5 = real-graph regime where cache_by_degree sits "
                    "between random and presample — table6/fig12 config)")
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    if args.cpu_mesh:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from fgnn_tpu.cache.manager import FeatureCache
    from fgnn_tpu.cache.policy import build_ranking, rank_fake_optimal
    from fgnn_tpu.cache.presample import presample_ranking
    from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.engine import OneChipEngine
    import jax
    import jax.numpy as jnp

    ds = make_synthetic_dataset(num_node=args.synthetic_nodes, avg_degree=15,
                                feat_dim=32, num_class=16, seed=0,
                                neighbor_skew=args.neighbor_skew,
                                neighbor_pref=args.neighbor_pref)
    cfg = RunConfig(model="graphsage", fanout=(5, 10, 15), batch_size=8000,
                    num_hidden=32, sample_type=SampleType.KHOP2)
    eng = OneChipEngine(cfg, ds)

    # collect one epoch of input_nodes (host) to score policies offline —
    # the 'optimal' line (profiler.cc ReportNodeAccessSimple analog)
    freq = np.zeros(ds.num_node, dtype=np.int64)
    batches = []
    base = jax.random.key(123)
    for seeds, n, step in eng.shuffler.batches(0):
        b = eng.sample_jit(jax.random.fold_in(base, step),
                           jnp.asarray(seeds), jnp.int32(n))
        ids = np.asarray(b.input_nodes)
        ids = ids[ids >= 0]
        batches.append(ids)
        np.add.at(freq, ids, 1)

    rankings = {}
    for pol in args.policies:
        if pol == "pre_sample":
            rankings[pol] = presample_ranking(
                eng.sample_jit, eng.shuffler, ds.num_node,
                presample_epoch=1, seed=0)
        else:
            rankings[pol] = build_ranking(ds, CachePolicy(pol), seed=0)
    rankings["optimal"] = rank_fake_optimal(freq)

    results = {}
    total = sum(len(b) for b in batches)
    for pol, ranking in rankings.items():
        results[pol] = {}
        for pct in args.percentages:
            k = int(pct * ds.num_node)
            cached = np.zeros(ds.num_node, dtype=bool)
            cached[ranking[:k]] = True
            hits = sum(int(cached[b].sum()) for b in batches)
            hit_rate = hits / max(total, 1)
            results[pol][pct] = round(hit_rate, 4)
            print(f"policy={pol} pct={pct:.0%} hit_rate={hit_rate:.1%}")

    with open(os.path.join(HERE, "fig10.json"), "w") as f:
        json.dump(results, f, indent=2)
    # gnuplot-style table like the other exp dirs (policy x percentage)
    with open(os.path.join(HERE, "fig10.dat"), "w") as f:
        pcts = args.percentages
        f.write("policy\t" + "\t".join(f"{p:.0%}" for p in pcts) + "\n")
        for pol, row in results.items():
            f.write(pol + "\t"
                    + "\t".join(f"{row[p]:.4f}" for p in pcts) + "\n")
    print("wrote", os.path.join(HERE, "fig10.dat"))


if __name__ == "__main__":
    main()
