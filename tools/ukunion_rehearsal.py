"""uk-union-scale int64 rehearsal.

The reference ships uk-2006-05 (77M nodes / 2.9B edges) and a 32to64
converter (utility/data-process/toolkit/generator/32to64.cc) because a
>2^31-edge CSR needs 64-bit indptr. The int64 path here is unit-tested
(tests/test_int64_edges.py) but had never been stood up at scale; this
tool generates a uk-shaped synthetic with MORE than 2^31 edges (int64
indptr, disk-backed int32 indices) and runs a real arch0 epoch: native
OpenMP host sampling over the 64-bit CSR + jitted training on the
device. Host-resident topology is the reference's uk-union operating
point (its arch0/cpu engine).

Usage:
  python tools/ukunion_rehearsal.py --gen-only        # host-side, no jax
  python tools/ukunion_rehearsal.py                   # epoch on the device
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache", "ukunion",
)
NUM_NODE = 77_000_000
TARGET_EDGES = 2_300_000_000      # > 2^31 = 2_147_483_648


def generate(out_dir: str, seed: int = 0):
    """Disk-backed synthetic at uk-union shape: lognormal degrees scaled
    to TARGET_EDGES, int64 indptr, chunked random int32 indices."""
    os.makedirs(out_dir, exist_ok=True)
    done = os.path.join(out_dir, "DONE")
    if os.path.exists(done):
        print(f"# dataset already generated at {out_dir}")
        return
    t0 = time.time()
    rng = np.random.default_rng(seed)
    deg = rng.lognormal(mean=3.0, sigma=1.0, size=NUM_NODE)
    deg = np.maximum((deg * (TARGET_EDGES / deg.sum())).astype(np.int64), 1)
    indptr = np.zeros(NUM_NODE + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    num_edge = int(indptr[-1])
    assert num_edge > 2**31, num_edge
    np.save(os.path.join(out_dir, "indptr.npy"), indptr)
    print(f"# indptr: {num_edge} edges ({time.time()-t0:.0f}s)", flush=True)

    idx_path = os.path.join(out_dir, "indices.npy")
    indices = np.lib.format.open_memmap(
        idx_path, mode="w+", dtype=np.int32, shape=(num_edge,)
    )
    chunk = 64_000_000
    for lo in range(0, num_edge, chunk):
        hi = min(lo + chunk, num_edge)
        indices[lo:hi] = rng.integers(0, NUM_NODE, hi - lo, dtype=np.int32)
        if (lo // chunk) % 8 == 0:
            print(f"# indices {hi/num_edge:.0%} ({time.time()-t0:.0f}s)",
                  flush=True)
    indices.flush()
    open(done, "w").write(f"{NUM_NODE} {num_edge}\n")
    print(f"# generated {num_edge} edges in {time.time()-t0:.0f}s "
          f"({os.path.getsize(idx_path)/1e9:.1f} GB)", flush=True)


def run_epoch(out_dir: str, batch_size: int, train_n: int, num_epoch: int):
    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from fgnn_tpu.config import RunArch, RunConfig, SampleType
    from fgnn_tpu.data.schema import Dataset
    from fgnn_tpu.host_engine import HostSamplingEngine

    indptr = np.load(os.path.join(out_dir, "indptr.npy"))
    indices = np.load(os.path.join(out_dir, "indices.npy"), mmap_mode="r")
    assert indptr.dtype == np.int64 and indptr[-1] > 2**31
    rng = np.random.default_rng(7)
    ids = rng.choice(NUM_NODE, size=train_n + 2048,
                     replace=False).astype(np.int32)
    feat = rng.standard_normal((1_000_000, 128)).astype(np.float32)
    label = rng.integers(0, 64, NUM_NODE, dtype=np.int32)
    ds = Dataset(
        name="ukunion-shape", num_node=NUM_NODE,
        num_edge=int(indptr[-1]), num_class=64,
        indptr=indptr, indices=indices, feat=feat, label=label,
        train_set=ids[:train_n], test_set=ids[train_n:train_n + 1024],
        valid_set=ids[train_n + 1024:], empty_feat=True,
    )
    cfg = RunConfig(
        model="graphsage", arch=RunArch.ARCH0, fanout=(25, 10),
        batch_size=batch_size, num_hidden=256,
        sample_type=SampleType.KHOP2, dropout=0.5, lr=0.003,
    )
    t0 = time.time()
    eng = HostSamplingEngine(cfg, ds)
    print(f"# engine init: {time.time()-t0:.1f}s (plan {eng.plan})",
          flush=True)
    for e in range(num_epoch):
        r = eng.run_epoch(e)
        print(f"test_result:epoch{e}_time={r['epoch_time']:.3f}")
        print(f"test_result:epoch{e}_loss={r['loss']:.4f}")
        print(f"# epoch {e}: {r['epoch_time']:.2f}s loss={r['loss']:.3f} "
              f"steps={r['num_step']} edges={r.get('sampled_edges')}",
              flush=True)
    print(f"test_result:num_edge={int(indptr[-1])}")
    print("# uk-union rehearsal OK: >2^31-edge CSR sampled natively "
          "(int64 indptr), trained on the device", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=DEFAULT_DIR)
    p.add_argument("--gen-only", action="store_true")
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--train-n", type=int, default=80_000)
    p.add_argument("--num-epoch", type=int, default=2)
    args = p.parse_args()
    generate(args.dir)
    if not args.gen_only:
        run_epoch(args.dir, args.batch_size, args.train_n, args.num_epoch)


if __name__ == "__main__":
    main()
