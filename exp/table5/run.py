"""Table 5 analog: FGNN sampler/trainer split sweep + switcher.

Reference: exp/table5 — FGNN epoch time as the 8 GPUs are split into
1S+7T ... 3S+5T, vs SGNN 8-worker, showing the factored design's
flexibility; the balance switcher recovers idle-sampler time.

Usage: python exp/table5/run.py [--cpu-mesh] [--num-epoch 4]
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
    p.add_argument("--model", default="graphsage")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 8000 on real chips (the reference "
                        "config); 2000 on the virtual CPU mesh, where "
                        "8000-seed 3-hop batches take minutes/step")
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()
    if args.batch_size is None:
        args.batch_size = 2000 if args.cpu_mesh else 8000
    if args.num_epoch is None:
        args.num_epoch = 3 if args.cpu_mesh else 4

    env = {}
    if args.cpu_mesh:
        env = {
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count="
                         f"{args.num_workers}",
        }

    n = args.num_workers
    configs = []
    for s in (1, 2, 3):
        if s < n:
            configs.append((f"{s}S+{n-s}T", ["--num-sample-worker", str(s),
                                             "--num-train-worker", str(n - s)]))
    configs.append((f"2S+{n-2}T+switch",
                    ["--num-sample-worker", "2",
                     "--num-train-worker", str(n - 2), "--have-switcher"]))

    # SGNN (arch6) baseline row, reference table5's space-shared column
    configs.append((f"SGNN-{n}w",
                    ["--arch", "arch6", "--num-train-worker", str(n)]))

    results = []
    for tag, workers in configs:
        app = [
            "examples/train_gnn.py", "--model", args.model,
            "--dataset", args.dataset,
            "--synthetic-nodes", str(args.synthetic_nodes),
            "--num-epoch", str(args.num_epoch),
            "--batch-size", str(args.batch_size),
            "--fanout", "5", "10", "15",
        ] + (workers if "--arch" in workers else ["--arch", "arch5"] + workers)
        r = run_app(app, os.path.join(HERE, "run-logs"), tag.replace("+", "_"),
                    env=env)
        r.config["split"] = tag
        r.config["synthetic_nodes"] = args.synthetic_nodes
        r.config["sample_type"] = MODEL_SAMPLE_TYPE[args.model]
        # second pass at profile level 2: per-stage split (stage timers
        # force a sync per stage, so the headline epoch_time comes from
        # the level-1 run above — the reference's profiled-run convention)
        rp = run_app(app + ["--profile-level", "2"],
                     os.path.join(HERE, "run-logs"),
                     tag.replace("+", "_") + "_stages", env=env)
        for k in ("sample_time", "copy_time", "extract_time", "train_time"):
            if rp.values.get(k):
                r.values[k] = rp.values[k]
        results.append(r)

    meta = cpu_mesh_meta(args.num_workers) if args.cpu_mesh else None
    write_table(results,
                ["split", "num_step", "epoch_time", "epoch_time:min",
                 "sample_time", "copy_time", "extract_time", "train_time"],
                os.path.join(HERE, "table5.dat"), meta=meta)
    write_json(results, os.path.join(HERE, "table5.json"), meta=meta)


if __name__ == "__main__":
    main()
