"""Figure 5 analog: gap between degree-based caching and optimal.

Reference exp/fig5a (README.md:1-12): sweep cache ratio, plot hit rate of
cache_by_degree vs the profiled optimal (per-batch access counts). 5a is
khop on papers100M; 5b is weighted sampling on twitter. Here both variants
run on the skewed synthetic (``--sample-type`` selects), scoring policies
offline against one epoch of real sampled batches — the same method as
the reference's report_optimal node-access profiling
(profiler.cc ReportNodeAccessSimple).

Usage: python exp/fig5/run.py [--cpu-mesh] [--synthetic-nodes N]
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
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.0, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30])
    p.add_argument("--sample-type", default="khop2",
                   help="khop2 (fig5a) or weighted_khop (fig5b)")
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--neighbor-pref", type=float, default=0.5)
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    if args.cpu_mesh:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fgnn_tpu.cache.policy import build_ranking, rank_fake_optimal
    from fgnn_tpu.cache.presample import presample_ranking
    from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.data.synthetic import build_alias_tables
    from fgnn_tpu.engine import OneChipEngine

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=16,
        num_class=16, seed=0, neighbor_skew=args.neighbor_skew,
        neighbor_pref=args.neighbor_pref)
    if args.sample_type.startswith("weighted"):
        build_alias_tables(ds, seed=0)
    cfg = RunConfig(model="graphsage", fanout=(5, 10, 15),
                    batch_size=args.batch_size, num_hidden=16,
                    sample_type=SampleType(args.sample_type))
    eng = OneChipEngine(cfg, ds)

    # one epoch of real batches -> per-node access counts (optimal's input)
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

    rankings = {
        "degree": build_ranking(ds, CachePolicy.DEGREE, seed=0),
        "pre_sample": presample_ranking(
            eng.sample_jit, eng.shuffler, ds.num_node,
            presample_epoch=1, seed=0),
        "optimal": rank_fake_optimal(freq),
    }

    total = sum(len(b) for b in batches)
    results = {}
    for pol, ranking in rankings.items():
        results[pol] = {}
        for pct in args.percentages:
            k = int(pct * ds.num_node)
            cached = np.zeros(ds.num_node, dtype=bool)
            if k:
                cached[ranking[:k]] = True
            hit = sum(int(cached[b].sum()) for b in batches) / max(total, 1)
            results[pol][pct] = round(hit, 4)
            print(f"policy={pol} pct={pct:.0%} hit_rate={hit:.1%}")

    suffix = "a" if not args.sample_type.startswith("weighted") else "b"
    out = os.path.join(HERE, f"fig5{suffix}.json")
    with open(out, "w") as f:
        json.dump({"config": vars(args), "hit_rate": results}, f, indent=2)
    with open(os.path.join(HERE, f"fig5{suffix}.dat"), "w") as f:
        f.write("pct\t" + "\t".join(results) + "\n")
        for pct in args.percentages:
            f.write(f"{pct:.2f}\t" +
                    "\t".join(f"{results[pol][pct]:.4f}" for pol in results)
                    + "\n")
    print("wrote", out)


if __name__ == "__main__":
    main()
