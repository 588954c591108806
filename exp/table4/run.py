"""Table 4 analog: end-to-end epoch time, FGNN (arch5) vs SGNN (arch6).

Reference: exp/table4 — DGL/PyG/SGNN/FGNN epoch times per model x dataset.
Here: our arch5 vs arch6 on the available dataset (synthetic by default,
real binary datasets if --dataset given and present on disk).

Usage: python exp/table4/run.py [--dataset synthetic] [--num-epoch 5]
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
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--synthetic-nodes", type=int, default=200_000)
    p.add_argument("--num-epoch", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=8,
                   help="total chips (arch5 splits S+T, arch6 uses all)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 8000 on real chips (the reference "
                        "config); 2000 on the virtual CPU mesh, where "
                        "8000-seed 3-hop batches take minutes/step")
    p.add_argument("--models", nargs="+",
                   default=["gcn", "graphsage", "pinsage"])
    p.add_argument("--cpu-mesh", action="store_true",
                   help="force 8-device virtual CPU mesh")
    args = p.parse_args()
    if args.batch_size is None:
        args.batch_size = 2000 if args.cpu_mesh else 8000
    if args.num_epoch is None:
        args.num_epoch = 3 if args.cpu_mesh else 4

    env = {}
    if args.cpu_mesh:
        env = {
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count=8",
        }

    results = []
    n = args.num_workers
    for model in args.models:
        for arch, workers in (
            ("arch5", ["--num-sample-worker", str(max(1, n // 4)),
                       "--num-train-worker", str(n - max(1, n // 4))]),
            ("arch6", ["--num-train-worker", str(n)]),
        ):
            app = [
                "examples/train_gnn.py", "--model", model, "--arch", arch,
                "--dataset", args.dataset,
                "--synthetic-nodes", str(args.synthetic_nodes),
                "--num-epoch", str(args.num_epoch),
                "--batch-size", str(args.batch_size),
                "--fanout", "5", "10", "15",
            ] + workers
            r = run_app(app, os.path.join(HERE, "run-logs"),
                        f"{model}_{arch}", env=env)
            r.config["model"] = model
            r.config["run_arch"] = arch
            r.config["synthetic_nodes"] = args.synthetic_nodes
            r.config["sample_type"] = MODEL_SAMPLE_TYPE[model]
            # stage split from a second, profile-level-2 pass
            rp = run_app(app + ["--profile-level", "2"],
                         os.path.join(HERE, "run-logs"),
                         f"{model}_{arch}_stages", env=env)
            for k in ("sample_time", "copy_time", "extract_time",
                      "train_time"):
                if rp.values.get(k):
                    r.values[k] = rp.values[k]
            results.append(r)

    meta = cpu_mesh_meta(8) if args.cpu_mesh else None
    write_table(results,
                ["model", "run_arch", "num_step", "epoch_time",
                 "sample_time", "copy_time", "extract_time", "train_time",
                 "init_time"],
                os.path.join(HERE, "table4.dat"), meta=meta)
    write_json(results, os.path.join(HERE, "table4.json"), meta=meta)


if __name__ == "__main__":
    main()
