"""Generic training app — all models, all archs.

Replaces the reference's per-model process-orchestration scripts
(example/samgraph/multi_gpu/train_{gcn,graphsage,pinsage}.py,
example/samgraph/sgnn/*, example/samgraph/train_*.py): the reference's
fork-per-GPU + mp.Barrier machinery becomes mesh role assignment inside
one process, so a single app covers arch1 (one device), arch5 (factored)
and arch6 (SGNN).

Emits the reference's machine-parseable result lines
(``test_result:epoch_time=...`` etc., train_gcn.py:411-412 format).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from examples.common_config import (
    add_common_arguments,
    build_run_config,
    load_app_dataset,
    print_run_config,
)
from fgnn_tpu.config import MODEL_SAMPLE_TYPE as DEFAULT_SAMPLE, RunArch
from fgnn_tpu.utils.logging import log_test_result
from fgnn_tpu.utils.profiler import Profiler


def parse_args(argv=None):
    p = argparse.ArgumentParser("fgnn_tpu training app")
    p.add_argument("--model", default="graphsage",
                   choices=list(DEFAULT_SAMPLE))
    add_common_arguments(p)
    return p.parse_args(argv)


def build_engine(cfg, ds):
    """The engine for ``cfg.arch``: arch1 one device, arch5 factored
    (optionally switcher or async), arch6 SGNN, arch0 host sampling."""
    if cfg.arch == RunArch.ARCH5:
        if cfg.have_switcher:
            from fgnn_tpu.parallel.switcher import SwitcherEngine

            return SwitcherEngine(cfg, ds)
        if cfg.async_train:
            from fgnn_tpu.parallel.async_dp import AsyncFactoredEngine

            return AsyncFactoredEngine(cfg, ds)
        from fgnn_tpu.parallel.factored import FactoredEngine

        return FactoredEngine(cfg, ds)
    if cfg.arch == RunArch.ARCH6:
        from fgnn_tpu.parallel.factored import SGNNEngine

        return SGNNEngine(cfg, ds)
    if cfg.arch == RunArch.ARCH0:
        from fgnn_tpu.host_engine import HostSamplingEngine

        return HostSamplingEngine(cfg, ds)
    from fgnn_tpu.engine import OneChipEngine

    return OneChipEngine(cfg, ds)


def main(argv=None):
    args = parse_args(argv)

    cfg = build_run_config(args, args.model, DEFAULT_SAMPLE[args.model])
    print_run_config(cfg)
    if args.validate_configs:
        return

    ds = load_app_dataset(args)

    t_init = time.time()
    eng = build_engine(cfg, ds)
    init_time = time.time() - t_init
    log_test_result("init_time", f"{init_time:.4f}")

    epoch_times = []
    for e in range(cfg.num_epoch):
        stats = eng.run_epoch(e)
        epoch_times.append(stats["epoch_time"])
        print(
            f"Epoch {e:05d} | Time {stats['epoch_time']:.4f} | "
            f"Loss {stats['loss']:.4f} | Acc {stats['acc']:.4f}"
        )
        if args.report_acc and (e + 1) % args.report_acc == 0 and hasattr(
            eng, "evaluate"
        ):
            log_test_result("test_acc", f"{eng.evaluate():.4f}")

    # reference convention: epoch 0 is warm-up (common_config.py:162-163)
    steady = epoch_times[1:] or epoch_times
    log_test_result("epoch_time", f"{np.mean(steady):.4f}")
    log_test_result("epoch_time:min", f"{np.min(steady):.4f}")
    log_test_result("num_step", str(Profiler.get().num_step))
    prof = Profiler.get()
    # stage columns: per-epoch seconds (reference table5 convention);
    # non-zero when --profile-level >= 2 wrote epoch stage items, else
    # approximated from per-step L1 items where those were recorded
    num_step = prof.num_step
    for col, epoch_item, l1_item in (
        ("sample_time", "epoch_sample_time", "L1_sample_time"),
        ("copy_time", "epoch_copy_time", "L1_copy_time"),
        ("extract_time", "epoch_extract_time", None),
        ("train_time", "epoch_train_time", "L1_train_time"),
    ):
        v = prof.epoch_average(epoch_item)
        if v == 0.0 and l1_item is not None:
            v = prof.step_average(l1_item) * num_step
        log_test_result(col, f"{v:.4f}")
    # per-stage / per-kernel items recorded at profile_level >= 2/3
    # (report_step_average L2/L3 analog, operation.cc:284-300)
    from fgnn_tpu.utils.profiler import STEP_ITEMS
    for item in STEP_ITEMS:
        if item.startswith("L1"):
            continue
        if prof.has_step_item(item):
            log_test_result(item, f"{prof.step_average(item):.6f}")
    fb = prof.epoch_average("epoch_feature_bytes")
    mb = prof.epoch_average("epoch_miss_bytes")
    if fb > 0:
        log_test_result("cache_hit_rate", f"{1.0 - mb / fb:.4f}")
        # staged miss volume per epoch: the chip-independent physical
        # effect the hit rate buys (kLogEpochMissBytes analog)
        log_test_result("miss_mb", f"{mb / 2**20:.2f}")
    if prof.log_node_access:
        prof.report_node_access("node", ds.num_node)
    log_test_result("init:presample", f"{prof.get_init_value('init_presample'):.4f}")
    log_test_result("init:load_dataset", f"{prof.get_init_value('init_load_dataset'):.4f}")
    log_test_result("init:copy", f"{prof.get_init_value('init_copy'):.4f}")
    log_test_result("init:build_cache", f"{prof.get_init_value('init_build_cache'):.4f}")
    if prof.trace_enabled:
        # samgraph_dump_trace analog (SAMGRAPH_DUMP_TRACE flow)
        import os
        prof.dump_trace(os.environ.get("FGNN_TPU_TRACE_PATH", "trace.json"))


if __name__ == "__main__":
    main()
