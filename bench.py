"""Flagship benchmark on one GPU.

Workload: GraphSAGE mini-batch epochs on a papers100M-flavoured synthetic
graph (1M nodes, average degree 15, 128-dim features, 172 classes, 25%
train split — ~32 steps per epoch), batch 8000, khop2 fanout [25, 10],
hidden 256, bf16 compute — the reference's flagship config (BASELINE.md),
run as the fully fused sample+extract+train epoch of ``OneChipEngine``
built through the training app (examples/train_gnn.py).

Everything runs in this one process. It exits non-zero unless JAX's
first device is a GPU, and prints ONE JSON line:
  {"metric", "value", "unit", "vs_baseline", "device", "gpu"}
``device`` is JAX's view of the card (platform, kind, count) and ``gpu``
the card's name and power limit from nvidia-smi.

``vs_baseline`` compares sampled edges per second per device with the
reference's implied rate: papers100M GraphSAGE on 8 V100s, 0.28 s/epoch
(exp/table4), ~150 steps x ~2.1M sampled edges/step ~= 1.1e9 edges/s,
i.e. ~1.4e8 per V100.

Env knobs:
  FGNN_BENCH_NODES           graph size           (default 1_000_000)
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

METRIC = "graphsage_synthetic1M_epoch_time"
REF_EDGES_PER_SEC_PER_DEVICE = 1.1e9 / 8


def main() -> int:
    import jax
    import numpy as np

    from fgnn_tpu.utils.device import (device_summary, gpu_name_and_power,
                                       require_gpu)

    require_gpu()
    gpu = gpu_name_and_power()

    from examples.common_config import (build_run_config, flagship_args,
                                        load_app_dataset)
    from examples.train_gnn import DEFAULT_SAMPLE, build_engine, parse_args

    args = parse_args(flagship_args(
        int(os.environ.get("FGNN_BENCH_NODES", 1_000_000))))
    cfg = build_run_config(args, args.model, DEFAULT_SAMPLE[args.model])
    t0 = time.perf_counter()
    ds = load_app_dataset(args)
    print(f"# dataset: {ds.num_node} nodes {ds.num_edge} edges "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    t0 = time.perf_counter()
    eng = build_engine(cfg, ds)
    print(f"# engine set-up: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # warm-up epoch (compiles; discarded, reference convention
    # common_config.py:162)
    t0 = time.perf_counter()
    eng.run_epoch(0)
    jax.block_until_ready(eng.state)
    print(f"# warm-up epoch: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)

    times, edges = [], 0
    for e in range(1, 4):
        t0 = time.perf_counter()
        stats = eng.run_epoch(e)
        jax.block_until_ready(eng.state)
        times.append(time.perf_counter() - t0)
        edges = max(edges, stats.get("sampled_edges", 0))
        print(f"# epoch {e}: {times[-1]:.4f}s loss={stats['loss']:.4f} "
              f"edges={stats.get('sampled_edges', 0)}", file=sys.stderr)

    epoch_time = float(np.median(times))
    payload = {
        "metric": METRIC,
        "value": epoch_time,
        "unit": "s",
        "vs_baseline": edges / epoch_time / REF_EDGES_PER_SEC_PER_DEVICE,
        "device": device_summary(),
        "gpu": gpu,
    }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
