"""Figure 14 analog: scalability of FGNN (arch5) vs SGNN (arch6).

Reference exp/fig14a/b (README.md:1-8): epoch time as the worker count
grows (1..8 GPUs) for DGL / SGNN / FGNN on GCN. Here: sweep total device
count n on the virtual CPU mesh (or a real pod slice); FGNN runs 1S+(n-1)T
(the paper's minimal-sampler split) and SGNN uses all n devices space-
shared. DGL is an external baseline (numbers in BASELINE.md).

Usage: python exp/fig14/run.py [--cpu-mesh] [--model gcn]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fgnn_tpu.config import MODEL_SAMPLE_TYPE
from exp.common.runner import (cpu_mesh_meta, run_app, write_json,
                               write_table)

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--num-epoch", type=int, default=3)
    p.add_argument("--model", default="gcn")
    p.add_argument("--batch-size", type=int, default=4000)
    p.add_argument("--worker-counts", nargs="+", type=int, default=[2, 4, 8])
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    results = []
    for n in args.worker_counts:
        env = {}
        if args.cpu_mesh:
            env = {
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": f"--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count={n}",
            }
        base = [
            "examples/train_gnn.py", "--model", args.model,
            "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
        ]
        for system, extra in (
            ("fgnn", ["--arch", "arch5", "--num-sample-worker", "1",
                      "--num-train-worker", str(n - 1)]),
            ("sgnn", ["--arch", "arch6", "--num-train-worker", str(n)]),
        ):
            tag = f"{system}_{n}w"
            print(f"[fig14] {tag}", flush=True)
            r = run_app(base + extra, os.path.join(HERE, "run-logs"), tag,
                        env=env)
            r.config["system"] = system
            r.config["workers"] = n
            r.config["synthetic_nodes"] = args.synthetic_nodes
            r.config["sample_type"] = MODEL_SAMPLE_TYPE.get(
                args.model, "khop2")
            results.append(r)

    # raw wall-clock on --cpu-mesh is labeled invalid
    meta = cpu_mesh_meta(max(args.worker_counts)) if args.cpu_mesh else None
    write_table(
        results,
        ["system", "workers", "num_step", "epoch_time", "epoch_time:min"],
        os.path.join(HERE, "fig14.dat"), meta=meta,
    )
    write_json(results, os.path.join(HERE, "fig14.json"), meta=meta)


if __name__ == "__main__":
    main()
