"""Shared app arguments + result reporting.

Analog of example/samgraph/multi_gpu/common_config.py: the same argparse
surface (--dataset, --arch, --cache-policy, ...), the same
``config:<k>=<v>`` / ``test_result:<k>=<v>`` machine-parseable output
(lines the exp/ harness regexes), and --validate-configs early exit.
"""
from __future__ import annotations

import argparse

from fgnn_tpu.config import CachePolicy, RunArch, RunConfig, SampleType
from fgnn_tpu.utils.logging import log_config


def add_common_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--root-path", default=None,
                   help="dataset root (reference binary layout)")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--synthetic-skew", type=float, default=2.0,
                   help="neighbor access skew (6 ~ papers100M-like)")
    p.add_argument("--synthetic-train-frac", type=float, default=0.1,
                   help="train split fraction of the synthetic graph "
                        "(sets steps/epoch)")
    p.add_argument("--synthetic-pref", type=float, default=0.0,
                   help="fraction of edges with preferential attachment "
                        "(hot targets = high out-degree nodes); 0.5 makes "
                        "degree-based caching meaningful like real graphs")
    p.add_argument("--arch", default="arch5",
                   choices=[f"arch{i}" for i in range(8)])
    p.add_argument("--sample-type", default=None)
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--num-epoch", type=int, default=10)
    p.add_argument("--num-hidden", type=int, default=256)
    p.add_argument("--fanout", nargs="+", type=int, default=[5, 10, 15])
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--num-sample-worker", type=int, default=1)
    p.add_argument("--num-train-worker", type=int, default=1)
    p.add_argument("--cache-policy", default="pre_sample")
    p.add_argument("--cache-percentage", type=float, default=0.0)
    p.add_argument("--presample-epoch", type=int, default=1)
    p.add_argument("--pipeline", action="store_true", default=True)
    p.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    p.add_argument("--num-random-walk", type=int, default=4)
    p.add_argument("--random-walk-length", type=int, default=3)
    p.add_argument("--random-walk-restart-prob", type=float, default=0.5)
    p.add_argument("--num-neighbor", type=int, default=5)
    p.add_argument("--num-layer", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-level", type=int, default=1,
                   help="1=headline timers (async-preserving); 2=per-stage "
                        "timers (forces a sync at stage boundaries); "
                        "3=per-kernel")
    p.add_argument("--validate-configs", action="store_true")
    p.add_argument("--report-acc", type=int, default=0,
                   help="evaluate test acc every N epochs (0=off)")
    # balance switcher (balance_switcher/train_pinsage.py analog)
    p.add_argument("--have-switcher", action="store_true")
    p.add_argument("--switch-cache-percentage", type=float, default=0.0)
    # async trainers (multi_gpu/async/train_graphsage.py analog)
    p.add_argument("--async-train", action="store_true")
    p.add_argument("--async-sync-every", type=int, default=1)


def flagship_args(num_node: int = 1_000_000, seed: int = 0) -> list:
    """The repo's flagship configuration as training-app arguments:
    GraphSAGE, khop2 fanout [25, 10], batch 8000, hidden 256, bf16
    compute, one device (arch1), on a papers100M-flavoured synthetic graph
    (average degree 15, 128-dim features, 172 classes) with a 25% train
    split (~32 steps per epoch at 1M nodes)."""
    return [
        "--model", "graphsage", "--arch", "arch1", "--sample-type", "khop2",
        "--fanout", "25", "10", "--batch-size", "8000",
        "--num-hidden", "256", "--dropout", "0.5", "--lr", "0.003",
        "--synthetic-nodes", str(num_node), "--synthetic-train-frac", "0.25",
        "--seed", str(seed),
    ]


def build_run_config(args, model: str, default_sample: str) -> RunConfig:
    st = SampleType(args.sample_type or default_sample)
    cfg = RunConfig(
        dataset=args.dataset,
        arch=RunArch(int(args.arch[4:])),
        sample_type=st,
        fanout=tuple(args.fanout),
        batch_size=args.batch_size,
        num_epoch=args.num_epoch,
        num_hidden=args.num_hidden,
        lr=args.lr,
        dropout=args.dropout,
        weight_decay=args.weight_decay,
        num_sample_worker=args.num_sample_worker,
        num_train_worker=args.num_train_worker,
        cache_policy=CachePolicy(args.cache_policy),
        cache_percentage=args.cache_percentage,
        presample_epoch=args.presample_epoch,
        pipeline=args.pipeline,
        model=model,
        num_random_walk=args.num_random_walk,
        random_walk_length=args.random_walk_length,
        random_walk_restart_prob=args.random_walk_restart_prob,
        num_neighbor=args.num_neighbor,
        num_layer_rw=args.num_layer,
        seed=args.seed,
        have_switcher=getattr(args, "have_switcher", False),
        switch_cache_percentage=getattr(args, "switch_cache_percentage", 0.0),
        async_train=getattr(args, "async_train", False),
        async_sync_every=getattr(args, "async_sync_every", 1),
        profile_level=getattr(args, "profile_level", 1),
    ).validate()
    from fgnn_tpu.utils.compile_cache import use_compile_cache
    from fgnn_tpu.utils.profiler import Profiler

    use_compile_cache()

    Profiler.get().level = max(Profiler.get().level, cfg.profile_level)
    return cfg


def print_run_config(cfg: RunConfig) -> None:
    import dataclasses

    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if hasattr(v, "value"):
            v = v.value
        log_config(f.name, v)


def load_app_dataset(args):
    """Load from the binary layout if present, else synthesize.

    Times the load into ``init_load_dataset`` (kLogInitL1LoadDataset
    analog — reference engine.cc LoadGraphDataset is timed by the init
    profiler, profiler.h:30-57)."""
    from fgnn_tpu.data import load_dataset, make_synthetic_dataset
    from fgnn_tpu.data.synthetic import build_alias_tables
    from fgnn_tpu.utils import Timer
    from fgnn_tpu.utils.profiler import Profiler

    t_load = Timer()
    if args.dataset != "synthetic":
        ds = load_dataset(args.dataset, root=args.root_path)
    else:
        ds = make_synthetic_dataset(
            num_node=args.synthetic_nodes, avg_degree=15, feat_dim=128,
            num_class=172, seed=args.seed,
            train_frac=getattr(args, "synthetic_train_frac", 0.1),
            neighbor_skew=getattr(args, "synthetic_skew", 2.0),
            neighbor_pref=getattr(args, "synthetic_pref", 0.0),
        )
        if (args.sample_type or "").startswith("weighted"):
            build_alias_tables(ds, seed=args.seed)
    Profiler.get().log_init("init_load_dataset", t_load.passed())
    return ds
