"""Figure 11 / Table 6 analog: cache-policy hit rate AND init cost.

Reference: exp/fig11 + exp/table6 — presampling achieves near-optimal hit
rate at degree-policy-like init cost. We measure, per policy:
ranking-build time (init cost) and achieved hit rate over training epochs.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--cache-percentage", type=float, default=0.1)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--neighbor-skew", type=float, default=6.0,
               help="access skew (6 ~ papers100M-like hot set)")
    p.add_argument("--neighbor-pref", type=float, default=0.5,
               help="table6/fig12 regime: degree between random and "
                    "presample")
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

    from fgnn_tpu.cache.manager import FeatureCache
    from fgnn_tpu.cache.policy import build_ranking, rank_fake_optimal
    from fgnn_tpu.cache.presample import presample_ranking
    from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.engine import OneChipEngine

    ds = make_synthetic_dataset(
        num_node=args.synthetic_nodes, avg_degree=15, feat_dim=64,
        num_class=32, seed=0, neighbor_skew=args.neighbor_skew,
        neighbor_pref=args.neighbor_pref,
    )
    cfg = RunConfig(model="graphsage", fanout=(10, 10), batch_size=1000,
                    sample_type=SampleType.KHOP0, dropout=0.0)
    eng = OneChipEngine(cfg, ds)  # reuse its compiled sampler

    # measure real access frequency once (for the optimal line)
    base = jax.random.key(123)
    freq = np.zeros(ds.num_node, dtype=np.int64)
    access_sets = []
    for e in range(args.num_epoch):
        for seeds, n, step in eng.shuffler.batches(e):
            key = jax.random.fold_in(base, e * eng.shuffler.num_step + step)
            b = eng.sample_jit(key, jnp.asarray(seeds), jnp.int32(n))
            ids = np.asarray(b.input_nodes)
            ids = ids[ids >= 0]
            np.add.at(freq, ids, 1)
            access_sets.append(ids)

    total_accesses = int(freq.sum())
    cache_n = int(args.cache_percentage * ds.num_node)

    def hit_rate(ranking):
        cached = np.zeros(ds.num_node, dtype=bool)
        cached[ranking[:cache_n]] = True
        hits = sum(int(cached[ids].sum()) for ids in access_sets)
        return hits / max(total_accesses, 1)

    results = []
    for policy in ("random", "degree", "degree_hop", "heuristic"):
        t0 = time.time()
        ranking = build_ranking(ds, CachePolicy(policy), seed=0)
        results.append({"policy": policy, "init_time": time.time() - t0,
                        "hit_rate": hit_rate(ranking)})

    t0 = time.time()
    ranking = presample_ranking(
        eng.sample_jit, eng.shuffler, ds.num_node, presample_epoch=1, seed=0
    )
    results.append({"policy": "pre_sample", "init_time": time.time() - t0,
                    "hit_rate": hit_rate(ranking)})

    results.append({"policy": "optimal", "init_time": 0.0,
                    "hit_rate": hit_rate(rank_fake_optimal(freq))})

    for r in results:
        print(f"test_result:hit_rate:{r['policy']}={r['hit_rate']:.4f}")
        print(f"test_result:init_time:{r['policy']}={r['init_time']:.4f}")
    with open(os.path.join(HERE, "fig11.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(HERE, "fig11.dat"), "w") as f:
        f.write("policy\thit_rate\tinit_time\n")
        for r in results:
            f.write(f"{r['policy']}\t{r['hit_rate']:.4f}\t"
                    f"{r['init_time']:.4f}\n")
    print(f"[exp] wrote {os.path.join(HERE, 'fig11.dat')}")


if __name__ == "__main__":
    main()
