"""Does per-fanout-run sorting of gather ids speed up the row gather?

Mean aggregation is order-invariant within a dst's fanout slots, so
sorting each 25-slot run is free semantically; this measures whether the
gather engine rewards piecewise-ascending address streams.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from fgnn_tpu.utils.compile_cache import use_compile_cache


def scan_time(name, body, steps, *args, reps=3):
    @jax.jit
    def prog(*a):
        def f(c, i):
            return c + body(i, *a).astype(jnp.float32), None
        acc, _ = jax.lax.scan(f, jnp.float32(0), jnp.arange(steps))
        return acc

    jax.block_until_ready(prog(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(prog(*args))
        ts.append(time.perf_counter() - t0)
    print(f"{name:46s} {min(ts)/steps*1e3:8.2f} ms", flush=True)


def main():
    use_compile_cache()
    d = jax.devices()[0]
    print(f"# device: {d.platform} {d.device_kind}", flush=True)
    key = jax.random.key(0)

    def kof(i):
        return jax.random.fold_in(key, i)

    T = jnp.asarray(np.random.rand(538_496, 128).astype(np.float32))
    NV, K = 80_768, 25
    M = NV * K

    def random_runs(i, t):
        ids = jax.random.randint(kof(i), (M,), 0, t.shape[0], jnp.int32)
        return jnp.sum(jnp.take(t, ids, axis=0))

    def sorted_runs(i, t):
        ids = jax.random.randint(kof(i), (NV, K), 0, t.shape[0], jnp.int32)
        ids = jnp.sort(ids, axis=1).reshape(-1)   # sort cost INCLUDED
        return jnp.sum(jnp.take(t, ids, axis=0))

    scan_time("take 2M ids random runs", random_runs, 8, T)
    scan_time("take 2M ids per-25-sorted runs", sorted_runs, 8, T)


if __name__ == "__main__":
    main()
