"""Bandwidth toolkit (utility/data-process/toolkit/bandwidth/
{memcpy_test.cc,mem_bandwidth.cc} analog): measures the memory paths the
training pipeline actually exercises —

    host gather      random feature rows on the host (native OpenMP
                     gather vs NumPy fancy-index) — the CPU extract stage
    host memcpy      straight np.copyto stream bandwidth
    H2D device_put   host -> device transfer (the miss-upload path)
    device gather    dynamic row gather on the device (the feature
                     extract of the fused step)

Device timings end in jax.block_until_ready; every device line names the
device it ran on.

Usage: python tools/bandwidth_bench.py [--rows N] [--dim D] [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(fn, reps=5):
    fn()
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def main():
    p = argparse.ArgumentParser("fgnn_tpu bandwidth bench")
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="feature-table rows")
    p.add_argument("--gather", type=int, default=200_000,
                   help="rows gathered per run")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--cpu", action="store_true", help="skip device paths")
    args = p.parse_args()

    rng = np.random.default_rng(0)
    feat = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
    ids = rng.integers(0, args.rows, size=args.gather).astype(np.int32)
    gbytes = args.gather * args.dim * 4 / 2**30

    # host gather: numpy fancy index vs native OpenMP gather
    t = bench(lambda: feat[ids])
    print(f"host gather (numpy):   {t*1e3:7.1f} ms  {gbytes/t:6.2f} GB/s")
    from fgnn_tpu import native
    if native.available():
        t = bench(lambda: native.gather_f32(feat, ids, n_real=len(ids)))
        print(f"host gather (native):  {t*1e3:7.1f} ms  {gbytes/t:6.2f} GB/s")
    else:
        print("host gather (native):  unavailable (ctypes lib not built)")

    # host stream copy (mem_bandwidth.cc analog)
    dst = np.empty_like(feat)
    fb = feat.nbytes / 2**30
    t = bench(lambda: np.copyto(dst, feat))
    print(f"host memcpy:           {t*1e3:7.1f} ms  {fb/t:6.2f} GB/s "
          f"({fb:.2f} GB)")

    if args.cpu:
        return

    import jax
    import jax.numpy as jnp

    from fgnn_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    d0 = jax.devices()[0]
    plat = f"{d0.platform} {d0.device_kind}"
    block = feat[: min(args.rows, 200_000)]
    bb = block.nbytes / 2**30
    def h2d():
        jax.block_until_ready(jax.device_put(block))
    t = bench(h2d, reps=3)
    print(f"H2D device_put [{plat}]: {t*1e3:7.1f} ms  {bb/t:6.2f} GB/s "
          f"({bb:.2f} GB)")

    feat_dev = jax.device_put(feat)
    ids_dev = jax.device_put(ids)
    g = jax.jit(lambda f, i: jnp.take(f, i, axis=0, mode="clip").sum())
    def dgather():
        jax.block_until_ready(g(feat_dev, ids_dev))
    t = bench(dgather, reps=3)
    rate = args.gather / t / 1e6
    print(f"device gather [{plat}]:  {t*1e3:7.1f} ms  {rate:6.1f} M rows/s "
          f"({gbytes/t:5.2f} GB/s out)")


if __name__ == "__main__":
    main()
