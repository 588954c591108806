"""Figure 12 analog: impact of cache policy on extract/copy time.

Reference exp/fig12 (readme.md:1-50): random vs degree vs presample at a
fixed cache percentage — hit rate drives the feature-copy stage time.
Same sweep here on the split path (host-resident features), per model.

Usage: python exp/fig12/run.py [--cpu-mesh] [--synthetic-nodes N]
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
    p.add_argument("--synthetic-nodes", type=int, default=1_000_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=4000)
    p.add_argument("--cache-percentage", type=float, default=0.2)
    p.add_argument("--models", nargs="+", default=["gcn", "graphsage"])
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    if args.cpu_mesh:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count=8"

    results = []
    for model in args.models:
        base = [
            "examples/train_gnn.py", "--model", model, "--arch", "arch1",
            "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
            "--synthetic-skew", "6", "--synthetic-pref", "0.5",
            "--cache-percentage", str(args.cache_percentage),
            "--profile-level", "2",
        ]
        for policy in ("random", "degree", "pre_sample"):
            tag = f"{model}_{policy}"
            print(f"[fig12] {tag}", flush=True)
            r = run_app(base + ["--cache-policy", policy],
                        os.path.join(HERE, "run-logs"), tag, env=env)
            r.config["model"] = model
            r.config["policy"] = policy
            results.append(r)

    meta = (cpu_mesh_meta(8) if getattr(args, 'cpu_mesh', False)
            else None)
    write_table(
        results,
        ["model", "policy", "cache_hit_rate", "copy_time", "train_time",
         "epoch_time", "epoch_time:min"],
        os.path.join(HERE, "fig12.dat"), meta=meta,
    )
    write_json(results, os.path.join(HERE, "fig12.json"), meta=meta)


if __name__ == "__main__":
    main()
