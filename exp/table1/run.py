"""Table 1 analog: the motivation ablation — where does epoch time go as
you move sampling to the device and add a feature cache?

Reference: exp/table1 (README.md:95-104) — DGL / +GPU-sampling / SGNN /
+caching / +sampling / +both, with Sample/Extract/Train/Total columns.
Our rows map the same two axes onto this system's mechanisms:

  host-sample            arch0: NumPy/native host sampling, host extract
  host-sample+cache      arch0 + presample device cache
  dev-sample             arch1 w/ host-resident features (no cache)
  dev-sample+cache       arch1 + presample device cache (arch2/3 shape)
  dev-sample+hbm-feat    arch1 with the whole feature matrix in device
                         memory (the fused path; no reference analog)

Stage columns come from a --profile-level 2 run (per-stage sync timing).

Usage: python exp/table1/run.py [--cpu-mesh] [--synthetic-nodes N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from exp.common.runner import (cpu_mesh_meta, run_app,
                               write_json, write_table)

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--model", default="graphsage")
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    env = {}
    if args.cpu_mesh:
        env = {"JAX_PLATFORMS": "cpu"}

    base = [
        "examples/train_gnn.py", "--model", args.model,
        "--dataset", args.dataset,
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
    ]
    cache = ["--cache-policy", "pre_sample",
             "--cache-percentage", str(args.cache_percentage)]
    host_feat = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}

    rows = [
        ("host-sample", ["--arch", "arch0"], {}),
        ("host-sample+cache", ["--arch", "arch0"] + cache, {}),
        ("dev-sample", ["--arch", "arch1"], host_feat),
        ("dev-sample+cache", ["--arch", "arch1"] + cache, host_feat),
        ("dev-sample+hbm-feat", ["--arch", "arch1"], {}),
    ]

    # Two passes per row: epoch_time from an UNINSTRUMENTED run (the
    # fused/fast path — the honest end-to-end number), stage columns
    # from a profile-level-2 run whose per-stage syncs serialize the
    # pipeline and therefore inflate absolute stage sums; the split is
    # for attribution, the level-1 epoch_time is the measurement (see
    # README).
    results = []
    for tag, extra, extra_env in rows:
        print(f"[table1] {tag}", flush=True)
        r = run_app(base + extra + ["--profile-level", "1"],
                    os.path.join(HERE, "run-logs"), tag + "-l1",
                    env={**env, **extra_env})
        r2 = run_app(base + extra + ["--profile-level", "2"],
                     os.path.join(HERE, "run-logs"), tag + "-l2",
                     env={**env, **extra_env})
        for k in ("sample_time", "copy_time", "extract_time",
                  "train_time"):
            if k in r2.values:
                r.values[k] = r2.values[k]
        r.values["epoch_time_l2"] = r2.values.get("epoch_time", "")
        r.config["system"] = tag
        results.append(r)

    meta = (cpu_mesh_meta(8) if getattr(args, 'cpu_mesh', False)
            else None)
    write_table(
        results,
        ["system", "sample_time", "copy_time", "extract_time",
         "train_time", "epoch_time", "epoch_time_l2"],
        os.path.join(HERE, "table1.dat"), meta=meta,
    )
    write_json(results, os.path.join(HERE, "table1.json"), meta=meta)


if __name__ == "__main__":
    main()
