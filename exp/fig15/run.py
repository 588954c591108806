"""Figure 15 analog: FGNN scalability breakdown (sample/extract/train).

Reference exp/fig15 (README.md:1-6): per-stage times of FGNN on GCN as
trainer count grows — showing the sample stage stays flat (it owns its
devices) while train time shrinks with trainers. Here: arch5 with 1
sampler and a growing trainer count on the CPU mesh (or pod slice),
profile level 2 for the per-stage wave timers.

Usage: python exp/fig15/run.py [--cpu-mesh]
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
    p.add_argument("--trainer-counts", nargs="+", type=int,
                   default=[1, 3, 7])
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    results = []
    for t in args.trainer_counts:
        n = t + 1
        env = {}
        if args.cpu_mesh:
            env = {
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": f"--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count={n}",
            }
        tag = f"1S+{t}T"
        print(f"[fig15] {tag}", flush=True)
        r = run_app([
            "examples/train_gnn.py", "--model", args.model,
            "--dataset", "synthetic",
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
            "--arch", "arch5", "--num-sample-worker", "1",
            "--num-train-worker", str(t),
            "--profile-level", "2",
        ], os.path.join(HERE, "run-logs"), tag, env=env)
        r.config["split"] = tag
        r.config["synthetic_nodes"] = args.synthetic_nodes
        r.config["sample_type"] = MODEL_SAMPLE_TYPE.get(
            args.model, "khop2")
        results.append(r)

    meta = (cpu_mesh_meta(max(args.trainer_counts) + 1)
            if args.cpu_mesh else None)
    write_table(
        results,
        ["split", "num_step", "sample_time", "copy_time", "train_time",
         "epoch_time"],
        os.path.join(HERE, "fig15.dat"), meta=meta,
    )
    write_json(results, os.path.join(HERE, "fig15.json"), meta=meta)


if __name__ == "__main__":
    main()
