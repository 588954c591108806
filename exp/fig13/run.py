"""Figure 13 analog: pipelining on/off ablation.

Reference: exp/fig13 runs the cached arch5 apps with `pipeline=True`
(dist_loops_arch5.cc's #ifdef PIPELINE overlap); the paper's claim is
that overlapping extract with train hides the feature-copy stage.

We A/B `--pipeline` / `--no-pipeline` on the two paths that implement the
2-stage overlap (host gather of step/group k+1 under device train of k):

  arch1+cache : OneChipEngine split path (engine.py
                _run_epoch_split_pipelined, cuda_loops_arch3.cc analog)
  arch5+cache : FactoredEngine group prep thread (dist_loops_arch5.cc
                PIPELINE analog)

Measured overlap = pipelined epoch < unpipelined epoch, with the same
per-stage sums (a scheduling change, not a work change).

Usage: python exp/fig13/run.py [--cpu-mesh] [--synthetic-nodes N]
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

    env = {"FGNN_TPU_FEAT_HBM_BUDGET": "0"}  # force host-resident feats
    if args.cpu_mesh:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_cpu_collective_call_terminate_timeout_seconds=600 --xla_force_host_platform_device_count=8"

    base = [
        "examples/train_gnn.py", "--model", args.model,
        "--dataset", args.dataset,
        "--synthetic-nodes", str(args.synthetic_nodes),
        "--num-epoch", str(args.num_epoch),
        "--batch-size", str(args.batch_size),
        "--fanout", "5", "10", "15",
        "--cache-policy", "pre_sample",
        "--cache-percentage", str(args.cache_percentage),
    ]

    rows = [
        ("arch1-nopipe", ["--arch", "arch1", "--no-pipeline"]),
        ("arch1-pipe", ["--arch", "arch1"]),
        ("arch5-nopipe", ["--arch", "arch5", "--num-sample-worker", "2",
                          "--num-train-worker", "6", "--no-pipeline"]),
        ("arch5-pipe", ["--arch", "arch5", "--num-sample-worker", "2",
                        "--num-train-worker", "6"]),
    ]

    results = []
    for tag, extra in rows:
        print(f"[fig13] {tag}", flush=True)
        r = run_app(base + extra, os.path.join(HERE, "run-logs"), tag,
                    env=env)
        r.config["case"] = tag
        results.append(r)

    meta = cpu_mesh_meta(8) if args.cpu_mesh else None
    write_table(results, ["case", "epoch_time", "epoch_time:min"],
                os.path.join(HERE, "fig13.dat"), meta=meta)
    write_json(results, os.path.join(HERE, "fig13.json"), meta=meta)

    # --- timeline lanes: a traced run whose dump carries the reference's
    # 19 typed step events (profiler.h:142-176). Consumed here into a
    # per-lane summary table (fig13_lanes.dat) + the raw chrome trace.
    trace_path = os.path.join(HERE, "fig13_trace.json")
    tenv = dict(env)
    tenv["FGNN_TPU_DUMP_TRACE"] = "1"
    tenv["FGNN_TPU_TRACE_PATH"] = trace_path
    print("[fig13] traced run (19-lane timeline)", flush=True)
    run_app(base + ["--arch", "arch1", "--no-pipeline",
                    "--profile-level", "3",
                    "--num-epoch", "2"],
            os.path.join(HERE, "run-logs"), "arch1-trace", env=tenv)
    import json
    ev = [e for e in json.load(open(trace_path))["traceEvents"]
          if e.get("ph") == "X"]
    lanes = {}
    for e in ev:
        s = lanes.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"] / 1e6
    from fgnn_tpu.utils.profiler import TRACE_ITEMS
    with open(os.path.join(HERE, "fig13_lanes.dat"), "w") as f:
        f.write("lane\tcount\ttotal_s\tmean_ms\n")
        for name in TRACE_ITEMS:
            c, tot = lanes.get(name, [0, 0.0])
            mean = tot / c * 1e3 if c else 0.0
            f.write(f"{name}\t{c}\t{tot:.4f}\t{mean:.3f}\n")
    print(f"[fig13] lanes -> fig13_lanes.dat ({len(ev)} events)", flush=True)

    # headline: overlap factor per arch
    by = {r.config["case"]: r for r in results}
    for arch in ("arch1", "arch5"):
        try:
            off = float(by[f"{arch}-nopipe"].values["epoch_time"])
            on = float(by[f"{arch}-pipe"].values["epoch_time"])
            print(f"[fig13] {arch}: pipeline {off:.3f}s -> {on:.3f}s "
                  f"({off / max(on, 1e-9):.2f}x)", flush=True)
        except (KeyError, ValueError):
            pass


if __name__ == "__main__":
    main()
