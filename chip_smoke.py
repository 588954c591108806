"""Smoke run of fgnn_tpu on one NVIDIA GPU — or, with --four-cards, four.

The quickest proof that the system still starts on the card. Everything
runs in this one process; a failed phase exits non-zero and prints no
result. One card, phases in order:

  (a) device   refuse anything but a GPU; print the card's name and power
               limit (nvidia-smi), JAX/jaxlib versions, XLA_FLAGS and the
               compile-cache directory.
  (b) main     the flagship configuration (examples/common_config.py
               flagship_args: GraphSAGE [25,10] khop2, batch 8000, hidden
               256, bf16, 1M-node synthetic graph from the seed) built
               through the training app into OneChipEngine's fused
               sample->extract->train epochs: set-up time, compile plus
               warm-up epoch, two timed epochs (each ending in
               block_until_ready), finite falling loss, no cap overflow,
               peak device memory and the feature budget chosen.
  (c) correct  one batch the engine samples on the card: the sanity
               checker passes and every real sampled edge is an edge of
               the CSR (host check); the bf16 forward tracks a float32
               forward at matmul precision "highest" within 3e-2 of the
               reference's scale, and that float32 forward matches the
               NumPy conv goldens (fgnn_tpu/ops/reference_impl.py) at 1e-4.
  (d) families GCN 3-hop [5,10,15] with dedup, PinSAGE random walk, GAT
               8 heads, GraphSAGE in presample-cache mode with host-staged
               misses — a few steps each on a 200K-node graph: finite
               loss, no overflow.
  (e) gather   XLA's device_gather alone at the flagship shape (the
               padded layer-0 input rows x 128 bf16): bytes/s over 7
               windows, beside the card's 3.35 TB/s.

With --four-cards only the factored path and what it is compared with
run: FactoredEngine (1 sampler + 3 trainers) against SGNNEngine (4
workers) at the flagship widths, a warm-up and one epoch each, mean
losses within 5%; sampler work on device 0 and trainer state on devices
1-3, with each device's peak memory; then the factored engine's two
bit-equality gates (__graft_entry__.bit_equality_gates, tiny shapes) in a
child process under --xla_gpu_deterministic_ops=true, since the gates
assume deterministic scatter-adds (GPU scatter-adds with repeated indices
are atomic and their order is not fixed).

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage:
  python chip_smoke.py                # one card
  python chip_smoke.py --four-cards   # four cards of one host
"""
import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
FLAGSHIP_NODES = 1_000_000
FAMILY_NODES = 200_000
BF16_TOL = 3e-2       # the bf16 bound of tests/test_model_golden.py
GOLDEN_TOL = 1e-4     # the f32 bound of tests/test_model_golden.py
LOSS_AGREE = 0.05     # factored vs SGNN mean loss
H100_HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet
GATHER_WINDOWS, GATHER_CALLS = 7, 50
DETERMINISTIC_FLAG = "--xla_gpu_deterministic_ops=true"

# (name, app arguments, FGNN_TPU_FEAT_HBM_BUDGET) of phase (d); each runs
# ~4 steps per epoch at FAMILY_NODES
FAMILIES = (
    ("gcn 3-hop [5,10,15] khop2 dedup",
     ["--model", "gcn", "--sample-type", "khop2", "--fanout", "5", "10",
      "15", "--batch-size", "8000", "--synthetic-train-frac", "0.16"], None),
    ("pinsage random walk",
     ["--model", "pinsage", "--sample-type", "random_walk",
      "--batch-size", "8000", "--synthetic-train-frac", "0.16"], None),
    ("gat 8 heads x 256, [25,10]",
     ["--model", "gat", "--sample-type", "khop2", "--fanout", "25", "10",
      "--batch-size", "8000", "--synthetic-train-frac", "0.16"], None),
    ("graphsage presample cache 10%, host-staged misses",
     ["--model", "graphsage", "--sample-type", "khop2", "--fanout", "25",
      "10", "--batch-size", "8000", "--synthetic-train-frac", "0.16",
      "--cache-policy", "pre_sample", "--cache-percentage", "0.1"], "0"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== phase {name}")
    t = time.perf_counter()
    yield
    log(f"== phase {name} passed in {time.perf_counter() - t:.1f}s")


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", "not reported")


def app_engine(argv):
    """(cfg, ds, engine) built the way examples/train_gnn.py builds them."""
    from examples.common_config import build_run_config, load_app_dataset
    from examples.train_gnn import DEFAULT_SAMPLE, build_engine, parse_args

    args = parse_args(argv)
    cfg = build_run_config(args, args.model, DEFAULT_SAMPLE[args.model])
    t = time.perf_counter()
    ds = load_app_dataset(args)
    log(f"dataset: {ds.num_node} nodes, {ds.num_edge} edges, "
        f"{len(ds.train_set)} train nodes ({time.perf_counter() - t:.1f}s)")
    t = time.perf_counter()
    eng = build_engine(cfg, ds)
    return cfg, ds, eng, time.perf_counter() - t


# --------------------------------------------------------------------------
# (a)
# --------------------------------------------------------------------------

def check_device(num_cards: int):
    import jax
    import jaxlib

    from fgnn_tpu.utils.compile_cache import use_compile_cache
    from fgnn_tpu.utils.device import gpu_name_and_power, require_gpu

    devs = require_gpu()
    check(len(devs) >= num_cards,
          f"needs {num_cards} GPUs, JAX sees {len(devs)}")
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power()}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {use_compile_cache()}")
    log(f"devices: {[f'{d.platform}:{d.id} {d.device_kind}' for d in devs]}")
    return devs[:num_cards]


# --------------------------------------------------------------------------
# (b)
# --------------------------------------------------------------------------

def main_path(num_node: int = FLAGSHIP_NODES):
    import jax
    import numpy as np

    from examples.common_config import flagship_args
    from fgnn_tpu.engine import OneChipEngine
    from fgnn_tpu.utils.profiler import Profiler

    Profiler.reset()
    cfg, ds, eng, setup_s = app_engine(flagship_args(num_node, SEED))
    check(isinstance(eng, OneChipEngine), f"built {type(eng).__name__}")
    check(eng.feat_on_device and eng.fused_step is not None,
          "flagship must take the fused on-device path")
    log(f"engine set-up: {setup_s:.2f}s; plan {eng.plan}")
    log(f"feature budget: {eng.feat_budget} bytes; features on device: "
        f"{eng.feat_on_device} ({ds.feat.shape[0] * ds.feat.shape[1] * 2} "
        "bytes bf16)")

    losses = []
    for e in range(3):
        t = time.perf_counter()
        stats = eng.run_epoch(e)
        jax.block_until_ready(eng.state)
        dt = time.perf_counter() - t
        what = "compile + warm-up epoch" if e == 0 else "timed epoch"
        log(f"{what} {e}: {dt:.4f}s loss {stats['loss']:.4f} "
            f"acc {stats['acc']:.4f} steps {stats['num_step']} "
            f"sampled edges {stats['sampled_edges']}")
        losses.append(stats["loss"])
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[2] < losses[0], f"loss not falling: {losses}")
    prof = Profiler.get()
    ovf = [prof.get_epoch_value(e, "epoch_cap_overflow") for e in range(3)]
    log(f"epoch_cap_overflow: {ovf}")
    check(all(v == 0 for v in ovf), f"cap overflow {ovf}")
    log(f"peak_bytes_in_use: {peak_bytes(jax.devices()[0])}")
    return ds, eng


# --------------------------------------------------------------------------
# (c)
# --------------------------------------------------------------------------

def csr_edge_check(batch, indptr, indices) -> int:
    """Every real sampled edge, mapped back to global ids, is an edge of
    the CSR (row = the seed it was sampled for). Returns the edge count.

    Every block's src and dst local spaces are prefixes of
    ``batch.input_nodes`` (the sampler's seeds-first renumbering), so
    global id = input_nodes[local]."""
    import numpy as np

    nodes = np.asarray(batch.input_nodes)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    csr_keys = np.sort(rows * n + indices)
    total = 0
    for bi, blk in enumerate(batch.blocks):
        m = np.asarray(blk.mask)
        src = nodes[np.asarray(blk.src_local)[m]].astype(np.int64)
        dst = nodes[np.asarray(blk.dst_local)[m]].astype(np.int64)
        check((src >= 0).all() and (dst >= 0).all(),
              f"block {bi}: an edge maps to a padding id")
        keys = dst * n + src
        pos = np.minimum(np.searchsorted(csr_keys, keys), len(csr_keys) - 1)
        bad = csr_keys[pos] != keys
        check(not bad.any(), f"block {bi}: {int(bad.sum())} of {len(keys)} "
              "sampled edges are not in the CSR")
        total += len(keys)
    return total


def golden_forward(params, batch, feats, dst_caps):
    """The GraphSAGE forward composed from the NumPy SAGEConv golden."""
    import numpy as np

    from fgnn_tpu.ops.reference_impl import golden_sageconv

    h = feats
    n_layer = len(batch.blocks)
    for i, blk in enumerate(batch.blocks):
        p = params[f"SAGEConv_{i}"]
        h = golden_sageconv(
            blk, h, dst_caps[i], np.asarray(p["fc_self"]["kernel"]),
            np.asarray(p["fc_self"]["bias"]),
            np.asarray(p["fc_neigh"]["kernel"]),
        )
        if i < n_layer - 1:
            h = np.maximum(h, 0.0)
        h = h.astype(np.float32)
    return h


def correctness(ds, eng):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fgnn_tpu.models import build_model
    from fgnn_tpu.ops.extract import device_gather
    from fgnn_tpu.ops.sanity import EpochSanityChecker

    cfg = eng.cfg
    seeds, n, _ = next(eng.shuffler.batches(0))
    key = jax.random.fold_in(jax.random.key(SEED), 0xC0DE)
    batch = eng.sample_jit(key, jnp.asarray(seeds), jnp.int32(n),
                           dedup=eng._train_dedup)
    EpochSanityChecker(ds.num_node).check_batch(batch, eng.plan)
    t = time.perf_counter()
    n_edges = csr_edge_check(batch, ds.indptr, ds.indices)
    log(f"sampler: check_batch passed; {n_edges} real sampled edges all in "
        f"the CSR ({time.perf_counter() - t:.1f}s host check)")

    params = eng.state.params
    dst_caps = eng.dst_caps
    out = jax.jit(lambda p, b, f: eng.model.apply(
        {"params": p}, b, device_gather(f, b.input_nodes), dst_caps,
        deterministic=True,
    ))(params, batch, eng.feat_dev)
    model32 = build_model(cfg.model, ds.feat_dim, cfg.num_hidden,
                          ds.num_class, eng.plan.num_layer, cfg.dropout,
                          dtype=None)
    feat32 = jnp.asarray(np.asarray(ds.feat, dtype=np.float32))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, b, f: model32.apply(
            {"params": p}, b, device_gather(f, b.input_nodes), dst_caps,
            deterministic=True,
        ))(params, batch, feat32)
    out = np.asarray(out, dtype=np.float32)[:n]
    ref = np.asarray(ref)[:n]
    check(np.isfinite(out).all() and np.isfinite(ref).all(),
          "non-finite logits")
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    log(f"model: bf16 vs f32-highest forward on the card, {n} x "
        f"{ref.shape[1]} logits: max |diff| {err:.3e}, reference scale "
        f"{scale:.3e}")
    np.testing.assert_allclose(out, ref, rtol=BF16_TOL, atol=BF16_TOL * scale)

    t = time.perf_counter()
    nodes = np.asarray(batch.input_nodes)
    feats_h = np.where((nodes >= 0)[:, None],
                       np.asarray(ds.feat)[np.maximum(nodes, 0)], 0.0
                       ).astype(np.float32)
    gold = golden_forward(jax.tree.map(np.asarray, params), batch, feats_h,
                          dst_caps)[:n]
    gerr = float(np.abs(ref - gold).max())
    log(f"model: f32-highest forward vs NumPy goldens: max |diff| "
        f"{gerr:.3e} ({time.perf_counter() - t:.1f}s host goldens)")
    np.testing.assert_allclose(ref, gold, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    return batch


# --------------------------------------------------------------------------
# (d)
# --------------------------------------------------------------------------

def families(num_node: int = FAMILY_NODES, families=FAMILIES):
    import jax
    import numpy as np

    from fgnn_tpu.placement import ENV_FEAT_BUDGET
    from fgnn_tpu.utils.profiler import Profiler

    for name, argv, budget in families:
        Profiler.reset()
        if budget is not None:
            os.environ[ENV_FEAT_BUDGET] = budget
        try:
            cfg, ds, eng, setup_s = app_engine(
                argv + ["--arch", "arch1", "--num-hidden", "256",
                        "--synthetic-nodes", str(num_node),
                        "--seed", str(SEED)])
            if budget is not None:
                check(eng.cache is not None and not eng.feat_on_device,
                      f"{name}: expected the cache path")
            losses = []
            for e in range(2):
                t = time.perf_counter()
                stats = eng.run_epoch(e)
                jax.block_until_ready(eng.state)
                losses.append(stats["loss"])
                log(f"{name}: epoch {e} {time.perf_counter() - t:.3f}s "
                    f"loss {stats['loss']:.4f} steps {stats['num_step']}")
        finally:
            os.environ.pop(ENV_FEAT_BUDGET, None)
        prof = Profiler.get()
        ovf = [prof.get_epoch_value(e, "epoch_cap_overflow")
               for e in range(2)]
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(all(v == 0 for v in ovf), f"{name}: cap overflow {ovf}")
        extra = ""
        fb = prof.epoch_average("epoch_feature_bytes")
        if fb:
            extra = (f", cache hit rate "
                     f"{1 - prof.epoch_average('epoch_miss_bytes') / fb:.4f}")
        log(f"{name}: OK (set-up {setup_s:.1f}s, no overflow{extra}, "
            f"peak_bytes_in_use {peak_bytes(jax.devices()[0])})")
        del eng


# --------------------------------------------------------------------------
# (e)
# --------------------------------------------------------------------------

def gather_timing(table, ids, windows: int = GATHER_WINDOWS,
                  calls: int = GATHER_CALLS):
    """device_gather alone: each window dispatches ``calls`` gathers and
    ends in block_until_ready. Bytes = rows read + rows written + ids."""
    import jax
    import numpy as np

    from fgnn_tpu.ops.extract import device_gather

    g = jax.jit(device_gather)
    jax.block_until_ready(g(table, ids))
    rows, dim = ids.shape[0], table.shape[1]
    nbytes = 2 * rows * dim * table.dtype.itemsize + rows * ids.dtype.itemsize
    per_call = []
    for _ in range(windows):
        t = time.perf_counter()
        for _ in range(calls):
            out = g(table, ids)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t) / calls)
    med = float(np.median(per_call))
    log(f"device_gather [{rows}, {dim}] {table.dtype}: per call median "
        f"{med * 1e6:.1f} us (windows min {min(per_call) * 1e6:.1f}, max "
        f"{max(per_call) * 1e6:.1f}); {nbytes / med / 1e12:.3f} TB/s of "
        f"{H100_HBM_BYTES_PER_S / 1e12:.2f} TB/s "
        f"({nbytes / med / H100_HBM_BYTES_PER_S:.1%})")


# --------------------------------------------------------------------------
# --four-cards
# --------------------------------------------------------------------------

def four_cards(devs, num_node: int = FLAGSHIP_NODES):
    failures = []
    try:
        factored_vs_sgnn(devs, num_node)
    except AssertionError as e:
        failures.append(f"factored vs sgnn: {e}")
        log(f"FAILED factored vs sgnn: {e}")
    # both parts run, so one call reports on both; either failing fails
    # the phase
    t = time.perf_counter()
    rc = bit_equality_gates_child(len(devs))
    log(f"bit-equality gates (device permutation, single vs multi device) "
        f"{'passed' if rc == 0 else f'FAILED rc={rc}'} on the cards "
        f"({time.perf_counter() - t:.1f}s)")
    if rc != 0:
        failures.append("bit-equality gates")
    check(not failures, "; ".join(failures))


def bit_equality_gates_child(num_cards: int) -> int:
    """__graft_entry__.bit_equality_gates in a child process, under
    --xla_gpu_deterministic_ops=true: the gates assume deterministic
    scatter-adds, and the flag (read when XLA starts) would also make the
    flagship runs of this process far slower. The child takes a tenth of
    each card's memory beside this process's reservation, and runs while
    this process waits."""
    import subprocess

    code = (
        "import sys, jax; sys.path.insert(0, {repo!r}); "
        "import __graft_entry__ as g; "
        "g.bit_equality_gates(jax.devices()[:{n}])"
    ).format(repo=REPO, n=num_cards)
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION="0.1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " "
                          + DETERMINISTIC_FLAG).strip())
    return subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=900).returncode


def factored_vs_sgnn(devs, num_node: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from examples.common_config import (build_run_config, flagship_args,
                                        load_app_dataset)
    from examples.train_gnn import DEFAULT_SAMPLE, parse_args
    from fgnn_tpu.config import RunArch
    from fgnn_tpu.parallel.factored import FactoredEngine, SGNNEngine
    from fgnn_tpu.utils.profiler import Profiler

    args = parse_args(flagship_args(num_node, SEED))
    cfg = build_run_config(args, args.model, DEFAULT_SAMPLE[args.model])
    ds = load_app_dataset(args)
    log(f"dataset: {ds.num_node} nodes, {ds.num_edge} edges")
    runs = (
        ("factored 1 sampler + 3 trainers", FactoredEngine,
         cfg.replace(arch=RunArch.ARCH5, num_sample_worker=1,
                     num_train_worker=3)),
        ("sgnn 4 workers", SGNNEngine,
         cfg.replace(arch=RunArch.ARCH6, num_train_worker=4)),
    )
    losses = {}
    for name, cls, c in runs:
        Profiler.reset()
        t = time.perf_counter()
        eng = cls(c, ds, devices=devs)
        log(f"{name}: set-up {time.perf_counter() - t:.1f}s")
        for e in range(2):
            t = time.perf_counter()
            stats = eng.run_epoch(e)
            jax.block_until_ready(eng.state)
            what = "compile + warm-up epoch" if e == 0 else "epoch"
            log(f"{name}: {what} {e} {time.perf_counter() - t:.3f}s loss "
                f"{stats['loss']:.4f} steps {stats['num_step']}")
        losses[name] = stats["loss"]
        ovf = Profiler.get().get_epoch_value(1, "epoch_cap_overflow")
        check(np.isfinite(stats["loss"]) and ovf == 0,
              f"{name}: loss {stats['loss']} overflow {ovf}")
        if cls is FactoredEngine:
            sampler = {d.id for d in eng.graph_s.indices.devices()}
            trainer = {d.id for x in jax.tree.leaves(eng.state)
                       for d in x.devices()}
            feats = {d.id for d in eng.feat_t.devices()}
            # one batch through the sampler->trainer transport the epoch
            # uses (device_put onto the trainer mesh)
            seeds, n, _ = next(eng.shufflers[0].batches(0))
            batch = eng.single_sample(jax.random.key(SEED),
                                      jnp.asarray(seeds), jnp.int32(n))
            sampled = {d.id for x in jax.tree.leaves(batch)
                       for d in x.devices()}
            received = {d.id for x in jax.tree.leaves(jax.device_put(
                batch, eng.roles.trainer_replicated)) for d in x.devices()}
            log(f"{name}: graph and sampled batch on devices "
                f"{sorted(sampler | sampled)}; received batch on "
                f"{sorted(received)}, train state on {sorted(trainer)}, "
                f"features on {sorted(feats)}")
            check(sampler == sampled == {devs[0].id},
                  "sampler work left device 0")
            want = {d.id for d in devs[1:]}
            check(trainer == want and feats == want and received == want,
                  "trainer state, features or received batch left "
                  "devices 1-3")
        log(f"{name}: peak_bytes_in_use per device "
            f"{[peak_bytes(d) for d in devs]}")
        del eng
    (fa, la), (sg, ls) = losses.items()
    rel = abs(la - ls) / abs(ls)
    log(f"mean epoch-1 loss: {fa} {la:.4f}, {sg} {ls:.4f}, "
        f"rel diff {rel:.2%}")
    check(rel < LOSS_AGREE, f"factored vs sgnn losses differ by {rel:.1%}")


# --------------------------------------------------------------------------

def select_phases(four_cards_run: bool):
    """Names of the phases a run executes, in order."""
    if four_cards_run:
        return ["device", "four-cards"]
    return ["device", "main", "correct", "families", "gather"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the factored-vs-SGNN phase on 4 GPUs")
    args = p.parse_args(argv)
    phases = select_phases(args.four_cards)

    with phase("(a) device"):
        devs = check_device(4 if args.four_cards else 1)
    if "four-cards" in phases:
        with phase("four-cards"):
            four_cards(devs)
    if "main" in phases:
        with phase("(b) main path"):
            ds, eng = main_path()
    if "correct" in phases:
        with phase("(c) correctness at real width"):
            batch = correctness(ds, eng)
        table, ids = eng.feat_dev, batch.input_nodes
        del eng
    if "families" in phases:
        with phase("(d) other families"):
            families()
    if "gather" in phases:
        with phase("(e) XLA gather"):
            gather_timing(table, ids)

    from fgnn_tpu.utils.device import device_summary

    print(json.dumps({"ok": True, "device": device_summary()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
