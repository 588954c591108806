"""Figure 4a analog: impact of cache ratio on feature extraction.

Reference exp/fig4a (README.md:1-8): sweep the cache percentage and
measure hit rate + extraction (feature copy) time — showing that when
device memory is spent on sampling state instead of cache, extraction
slows. Here: arch1 with host-resident features (FGNN_TPU_FEAT_HBM_BUDGET=0
forces the split extract path), pre_sample policy, sweeping
``--cache-percentage``.

Usage: python exp/fig4a/run.py [--cpu-mesh] [--synthetic-nodes N]
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
    p.add_argument("--batch-size", type=int, default=2000)
    p.add_argument("--percentages", nargs="+", type=float,
                   default=[0.0, 0.05, 0.1, 0.2, 0.3])
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}
    if args.cpu_mesh:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count=8"

    base = [
        "examples/train_gnn.py", "--model", "graphsage", "--arch", "arch1",
        "--dataset", "synthetic",
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
        "--synthetic-skew", "6", "--synthetic-pref", "0.5",
        "--cache-policy", "pre_sample", "--presample-epoch", "1",
        "--profile-level", "2",
    ]
    results = []
    for pct in args.percentages:
        tag = f"cache_{int(pct * 100):02d}"
        print(f"[fig4a] {tag}", flush=True)
        r = run_app(base + ["--cache-percentage", str(pct)],
                    os.path.join(HERE, "run-logs"), tag, env=env)
        r.config["cache_percentage"] = pct
        r.config["num_node"] = args.synthetic_nodes  # consumed by fig4b
        results.append(r)

    meta = (cpu_mesh_meta(8) if getattr(args, 'cpu_mesh', False)
            else None)
    write_table(
        results,
        ["cache_percentage", "cache_hit_rate", "copy_time", "extract_time",
         "train_time", "epoch_time"],
        os.path.join(HERE, "fig4a.dat"), meta=meta,
    )
    write_json(results, os.path.join(HERE, "fig4a.json"), meta=meta)


if __name__ == "__main__":
    main()
