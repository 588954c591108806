"""papers100M-scale dress rehearsal on one GPU.

Generates a papers100M-shaped synthetic graph (111M nodes / ~1.6B edges,
int32 indptr — papers100M's 1.615B edges fit under 2^31) with a small
fake feature table (SAMGRAPH_EMPTY_FEAT analog, engine.cc:138-155,
indexed modulo like GPUMockExtract) and runs:

  --mode hbm    arch1 fused epoch, graph + fake features on the device.
                Headline: steady-state epoch time / sampled edges/s.
  --mode cache  arch2/3 split path with a presample bf16 cache
                (host-resident misses); reports the measured hit rate.
                Use --train-frac to bound steps.

Timing: persistent compile cache (fgnn_tpu.utils.compile_cache), the
first epoch discarded as warm-up.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-node", type=int, default=111_059_956)
    p.add_argument("--avg-degree", type=float, default=14.5)
    p.add_argument("--neighbor-skew", type=float, default=6.0)
    p.add_argument("--neighbor-lognormal-sigma", type=float, default=3.0)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--fanout", type=int, nargs="+", default=[25, 10])
    p.add_argument("--train-frac", type=float, default=0.01)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--mode", choices=["hbm", "cache"], default="hbm")
    p.add_argument("--cache-percentage", type=float, default=0.15)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-level", type=int, default=1,
                   help="2 forces the stepwise path with per-stage "
                        "timers")
    p.add_argument("--cache-dir",
                   default=os.path.join(REPO, ".bench_cache", "p100m"),
                   help="generation takes 25-45 min host-side; save the "
                        "arrays once and mmap them on later runs "
                        "(train split regenerated per --train-frac)")
    p.add_argument("--gen-only", action="store_true",
                   help="generate + save the dataset and exit (host-side "
                        "work only)")
    args = p.parse_args()

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    import numpy as np

    from fgnn_tpu.config import CachePolicy, RunConfig, SampleType
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.data.schema import Dataset
    from fgnn_tpu.engine import OneChipEngine
    from fgnn_tpu.utils.profiler import Profiler

    t0 = time.perf_counter()
    cd = args.cache_dir
    stamp = (f"n{args.num_node}_d{int(args.avg_degree)}"
             f"_s{args.neighbor_skew}_l{args.neighbor_lognormal_sigma}"
             f"_seed{args.seed}")
    if cd and os.path.exists(os.path.join(cd, stamp, "indices.npy")):
        d = os.path.join(cd, stamp)
        indptr = np.load(os.path.join(d, "indptr.npy"), mmap_mode="r")
        indices = np.load(os.path.join(d, "indices.npy"), mmap_mode="r")
        feat = np.load(os.path.join(d, "feat.npy"), mmap_mode="r")
        label = np.load(os.path.join(d, "label.npy"), mmap_mode="r")
        rng = np.random.default_rng(args.seed + 99)
        n_train = max(1, int(args.num_node * args.train_frac))
        ids = rng.choice(args.num_node, size=n_train + 2048,
                         replace=False).astype(np.int32)
        ds = Dataset(
            name="papers100m-shape", num_node=args.num_node,
            num_edge=int(indices.shape[0]), num_class=172,
            indptr=indptr, indices=indices, feat=feat, label=label,
            train_set=ids[:n_train], test_set=ids[n_train:n_train + 1024],
            valid_set=ids[n_train + 1024:],
            empty_feat=feat.shape[0] < args.num_node,
        )
        print(f"[gen] loaded {d} ({ds.num_edge} edges) "
              f"in {time.perf_counter() - t0:.0f}s", flush=True)
    else:
        ds = make_synthetic_dataset(
            num_node=args.num_node, avg_degree=int(args.avg_degree),
            feat_dim=128, num_class=172, train_frac=args.train_frac,
            seed=args.seed, neighbor_skew=args.neighbor_skew,
            neighbor_lognormal_sigma=args.neighbor_lognormal_sigma,
            empty_feat_rows=1 << 20, name="papers100m-shape",
        )
        print(f"[gen] {ds.num_node} nodes / {ds.num_edge} edges "
              f"({ds.num_edge * 4 / 2**30:.1f} GB indices) "
              f"in {time.perf_counter() - t0:.0f}s", flush=True)
        if cd:
            d = os.path.join(cd, stamp)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "indptr.npy"), ds.indptr)
            np.save(os.path.join(d, "indices.npy"), ds.indices)
            np.save(os.path.join(d, "feat.npy"), ds.feat)
            np.save(os.path.join(d, "label.npy"), ds.label)
            print(f"[gen] saved to {d}", flush=True)
    assert ds.num_edge < 2**31, "int32 indptr bound"
    if args.gen_only:
        print("[gen] --gen-only: dataset ready, exiting", flush=True)
        return

    if args.mode == "hbm":
        cfg = RunConfig(
            model=args.model, fanout=tuple(args.fanout),
            batch_size=args.batch_size, num_hidden=256,
            sample_type=SampleType.KHOP2, dropout=0.5, lr=0.003,
            profile_level=args.profile_level,
        )
    else:
        os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
        cfg = RunConfig(
            model=args.model, fanout=tuple(args.fanout),
            batch_size=args.batch_size, num_hidden=256,
            sample_type=SampleType.KHOP2, dropout=0.5, lr=0.003,
            cache_policy=CachePolicy.PRESAMPLE,
            cache_percentage=args.cache_percentage,
            presample_epoch=1, profile_level=max(1, args.profile_level),
        )

    t0 = time.perf_counter()
    eng = OneChipEngine(cfg, ds)
    print(f"[init] engine up in {time.perf_counter() - t0:.0f}s "
          f"(incl. device transfer{' + presample' if args.mode == 'cache' else ''})",
          flush=True)

    times = []
    for e in range(args.num_epoch):
        r = eng.run_epoch(e)
        print(f"[epoch {e}] {r}", flush=True)
        if e > 0:
            times.append(r["epoch_time"])
        if args.mode == "cache":
            prof = Profiler.get()
            miss = prof.get_epoch_value(e, "epoch_miss_bytes")
            tot = prof.get_epoch_value(e, "epoch_feature_bytes")
            if tot:
                print(f"[epoch {e}] cache hit rate "
                      f"{100 * (1 - miss / tot):.1f}% "
                      f"({miss / 2**20:.0f} / {tot / 2**20:.0f} MB)",
                      flush=True)
    if times:
        med = float(np.median(times))
        edges = r.get("sampled_edges", 0)
        print(f"[result] median steady epoch {med:.2f}s"
              + (f", {edges / med / 1e6:.1f}M sampled edges/s" if edges
                 else ""), flush=True)


if __name__ == "__main__":
    main()
