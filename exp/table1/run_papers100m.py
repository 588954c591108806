"""Table 1 at papers100M scale on one GPU.

Rows mirror exp/table1/run.py's motivation ablation, at the reference's
flagship dataset shape — 111,059,956 nodes / ~1.5B edges (synthetic at
shape, generated from a seed by tools/papers100m_rehearsal.py --gen-only)
with the SAMGRAPH_EMPTY_FEAT-style 1M-row mock feature table:

  host-sample          arch0 native host sampling + host extract
  dev-sample           arch1, host-resident features (every row stages
                       over the host link — bounded via --dev-train-frac)
  dev-sample+cache     arch1 + 10% presample device cache (the
                       reference's papers100M operating point)
  dev-sample+hbm-feat  arch1 with the mock feature table on the device

Two passes per row: a level-1 run for the headline epoch time, then a
level-2 pass for the stage split (each stage timer syncs, so its epoch
time is an observability number).

Usage:
  python exp/table1/run_papers100m.py --cache-dir <dataset dir>
  python exp/table1/run_papers100m.py --cache-dir <dir> --rows hbm cache
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fgnn_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

ROWS = ["host", "dev", "cache", "hbm"]
ROW_LABEL = {
    "host": "host-sample",
    "dev": "dev-sample",
    "cache": "dev-sample+cache",
    "hbm": "dev-sample+hbm-feat",
}


def load_p100m(cache_dir, num_node, train_frac, seed=0):
    import numpy as np

    from fgnn_tpu.data.schema import Dataset

    stamp = f"n{num_node}_d14_s6.0_l3.0_seed{seed}"
    d = os.path.join(cache_dir, stamp)
    assert os.path.exists(os.path.join(d, "indices.npy")), (
        f"dataset cache missing at {d}; run tools/papers100m_rehearsal.py "
        "--gen-only first"
    )
    indptr = np.load(os.path.join(d, "indptr.npy"), mmap_mode="r")
    indices = np.load(os.path.join(d, "indices.npy"), mmap_mode="r")
    feat = np.load(os.path.join(d, "feat.npy"), mmap_mode="r")
    label = np.load(os.path.join(d, "label.npy"), mmap_mode="r")
    rng = np.random.default_rng(seed + 99)
    n_train = max(1, int(num_node * train_frac))
    ids = rng.choice(num_node, size=n_train + 2048,
                     replace=False).astype(np.int32)
    return Dataset(
        name="papers100m-shape", num_node=num_node,
        num_edge=int(indices.shape[0]), num_class=172,
        indptr=indptr, indices=indices, feat=feat, label=label,
        train_set=ids[:n_train], test_set=ids[n_train:n_train + 1024],
        valid_set=ids[n_train + 1024:],
        empty_feat=feat.shape[0] < num_node,
    )


def run_row(row, ds, args):
    import numpy as np

    from fgnn_tpu.config import CachePolicy, RunArch, RunConfig, SampleType
    from fgnn_tpu.utils.profiler import Profiler

    def build(profile_level):
        Profiler.reset()
        st = {"gcn": SampleType.KHOP2, "graphsage": SampleType.KHOP2,
              "pinsage": SampleType.RANDOM_WALK}[args.model]
        kw = dict(
            model=args.model, fanout=tuple(args.fanout),
            batch_size=args.batch_size,
            num_hidden=256, sample_type=st, dropout=0.5,
            lr=0.003, profile_level=profile_level,
            # the stage pass must take the serial stepwise path — the
            # split-pipelined epoch only logs L1 items (its overlap makes
            # per-stage spans meaningless), and table1 needs the
            # Extract/Copy split
            pipeline=profile_level < 2,
        )
        if args.model == "pinsage":
            kw.update(num_layer_rw=2, num_random_walk=4,
                      random_walk_length=3, num_neighbor=5)
            kw.pop("fanout", None)
        if row == "host":
            kw["arch"] = RunArch.ARCH0
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
        elif row == "dev":
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
        elif row == "cache":
            os.environ["FGNN_TPU_FEAT_HBM_BUDGET"] = "0"
            kw.update(cache_policy=CachePolicy.PRESAMPLE,
                      cache_percentage=args.cache_percentage,
                      presample_epoch=1)
        else:  # hbm: the 1M-row mock table fits HBM
            os.environ.pop("FGNN_TPU_FEAT_HBM_BUDGET", None)
        cfg = RunConfig(**kw)
        if row == "host":
            from fgnn_tpu.host_engine import HostSamplingEngine

            return HostSamplingEngine(cfg, ds), cfg
        from fgnn_tpu.engine import OneChipEngine

        return OneChipEngine(cfg, ds), cfg

    out = {"system": ROW_LABEL[row], "model": args.model}
    phase = getattr(args, "phase", "both")
    if phase in ("both", "headline"):
        # pass 1: headline epoch time at level 1
        t0 = time.perf_counter()
        eng, cfg = build(1)
        out["init_time"] = round(time.perf_counter() - t0, 1)
        times = []
        for e in range(args.num_epoch):
            r = eng.run_epoch(e)
            print(f"[{row}] epoch {e}: {r['epoch_time']:.2f}s "
                  f"loss={r['loss']:.3f}", flush=True)
            if e > 0:
                times.append(r["epoch_time"])
        out["epoch_time"] = round(
            float(np.median(times or [r["epoch_time"]])), 3)
        prof = Profiler.get()
        fb = prof.epoch_average("epoch_feature_bytes")
        mb = prof.epoch_average("epoch_miss_bytes")
        if fb:
            out["cache_hit_rate"] = round(1.0 - mb / fb, 4)
        del eng

    # pass 2: stage split at level 2 (syncs per stage — observability run)
    if phase in ("both", "stages") and not args.skip_stages:
        try:
            eng, cfg = build(2)
            for e in range(min(2, args.num_epoch)):
                eng.run_epoch(e)
            prof = Profiler.get()
            for col, item in (("sample_time", "epoch_sample_time"),
                              ("copy_time", "epoch_copy_time"),
                              ("extract_time", "epoch_extract_time"),
                              ("train_time", "epoch_train_time")):
                out[col] = round(prof.epoch_average(item), 3)
            out["epoch_time_l2"] = round(
                prof.epoch_average("epoch_total_time"), 3)
            del eng
        except Exception as e:
            # expected failure mode at 111M: the level-2 engine cannot fit
            # next to the headline pass's HBM residue (allocator error).
            # Anything else is a BUG — re-raise so the parent marks the
            # phase failed instead of writing a silently partial artifact.
            msg = f"{type(e).__name__}: {e}"
            if "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg:
                print(f"[{row}] stage pass OOM; keeping headline columns",
                      flush=True)
            else:
                raise
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cache-dir", required=True,
                   help="dataset directory written by "
                        "tools/papers100m_rehearsal.py --gen-only")
    p.add_argument("--model", default="graphsage",
                   choices=["graphsage", "gcn", "pinsage"],
                   help="gcn [5,10,15] is the reference's actual Table 1 "
                        "workload (exp/table1/README.md:95-104)")
    p.add_argument("--fanout", nargs="+", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--out-prefix", default="table1_papers100m",
                   help="artifact basename; smoke runs should redirect "
                        "(e.g. /tmp/t1smoke) so CPU rows never merge into "
                        "the chip artifact")
    p.add_argument("--num-node", type=int, default=111_059_956)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--cache-percentage", type=float, default=0.10)
    p.add_argument("--train-frac", type=float, default=0.01)
    p.add_argument("--dev-train-frac", type=float, default=0.0005,
                   help="the uncached host-feat row stages EVERY input "
                        "row over the host link; bound its steps")
    p.add_argument("--rows", nargs="+", default=["hbm", "cache", "dev",
                                                 "host"], choices=ROWS)
    p.add_argument("--skip-stages", action="store_true")
    p.add_argument("--phase", choices=["both", "headline", "stages"],
                   default="both",
                   help="at 111M nodes each engine build needs most of "
                        "the device memory — the parent runs headline and "
                        "stage passes as separate subprocesses")
    args = p.parse_args()
    use_compile_cache()
    if args.fanout is None:
        args.fanout = [5, 10, 15] if args.model == "gcn" else [25, 10]

    pref = args.out_prefix
    out_json = (pref + ".json" if os.sep in pref
                else os.path.join(HERE, pref + ".json"))
    if len(args.rows) > 1:
        # one subprocess per row: each row re-uploads the ~7GB graph, and
        # a fresh process is the only reliable way to return the previous
        # row's device memory to the allocator (the in-process `del eng` left enough
        # resident to RESOURCE_EXHAUST the next row's init at 111M nodes)
        import subprocess

        base = [sys.executable, os.path.abspath(__file__),
                "--cache-dir", args.cache_dir,
                "--model", args.model,
                "--fanout", *[str(f) for f in args.fanout],
                "--batch-size", str(args.batch_size),
                "--num-node", str(args.num_node),
                "--num-epoch", str(args.num_epoch),
                "--cache-percentage", str(args.cache_percentage),
                "--train-frac", str(args.train_frac),
                "--dev-train-frac", str(args.dev_train_frac),
                "--out-prefix", args.out_prefix]
        phases = (["headline"] if args.skip_stages
                  else ["headline", "stages"])
        failed = []
        for row in args.rows:
            for phase in phases:
                r = subprocess.run(
                    base + ["--rows", row, "--phase", phase])
                if r.returncode != 0:
                    print(f"[table1-p100m] row {row} phase {phase} "
                          f"FAILED rc={r.returncode}", flush=True)
                    failed.append((row, phase))
        if failed:
            print(f"[table1-p100m] {len(failed)} child run(s) failed: "
                  f"{failed}", flush=True)
            sys.exit(1)
        return

    results = []
    # merge with rows measured by earlier (sub)invocations — but only
    # rows whose parameters match this invocation (a prior run at a
    # different --num-node/--cache-percentage must not survive into an
    # artifact whose meta claims the new scale for every row)
    prior = {}
    if os.path.exists(out_json):
        try:
            with open(out_json) as f:
                prior = {(r["system"], r.get("model", "graphsage")): r
                         for r in json.load(f).get("results", [])}
        except Exception:
            pass
    for row in args.rows:
        frac = (args.dev_train_frac if row in ("dev", "host")
                else args.train_frac)
        params = {"num_node": args.num_node, "train_frac": frac,
                  "model": args.model, "batch_size": args.batch_size}
        if row == "cache":
            params["cache_percentage"] = args.cache_percentage
        old = dict(prior.get((ROW_LABEL[row], args.model), {}))
        if any(old.get(k) != v for k, v in params.items()):
            if old:
                print(f"[table1-p100m] dropping stale prior row "
                      f"{ROW_LABEL[row]} (params changed)", flush=True)
            old = {}
        ds = load_p100m(args.cache_dir, args.num_node, frac)
        print(f"[table1-p100m] row {row} (train_frac {frac}, "
              f"phase {args.phase})", flush=True)
        merged = old
        merged.update(run_row(row, ds, args))
        merged.update(params)
        prior[(ROW_LABEL[row], args.model)] = merged
    results = [prior[k] for r in ROWS for m in ("graphsage", "gcn", "pinsage")
               for k in [(ROW_LABEL[r], m)] if k in prior]

    import jax

    d0 = jax.devices()[0]
    meta = {"device": f"{d0.platform} {d0.device_kind} x{len(jax.devices())}",
            "dataset": (f"papers100M-shape synthetic {args.num_node} nodes, "
                        "generated from a seed")}
    cols = ["system", "model", "sample_time", "copy_time", "extract_time",
            "train_time", "epoch_time", "epoch_time_l2", "cache_hit_rate",
            "init_time"]
    with open(out_json[:-5] + ".dat", "w") as f:
        for k, v in meta.items():
            f.write(f"# {k}={v}\n")
        f.write("# NOTE: sample/copy/extract/train columns come from a "
                "SEPARATE force-synced profile-level-2 pass whose epoch "
                "wall-clock is epoch_time_l2; per-stage syncs serialize "
                "the pipeline, so those columns sum to epoch_time_l2, "
                "NOT to the headline epoch_time (async/pipelined pass).\n")
        f.write("\t".join(cols) + "\n")
        for r in results:
            f.write("\t".join(str(r.get(c, "X")) for c in cols) + "\n")
    with open(out_json, "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    print(f"[table1-p100m] wrote {out_json[:-5]}.dat/.json", flush=True)


if __name__ == "__main__":
    main()
