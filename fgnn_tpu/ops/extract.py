"""Feature / label extraction.

Analogs of the reference's extraction kernels:
  * device-resident gather  — cuda_extraction.cu:31-49 (GPUExtract)
  * mock extract            — cuda_extraction.cu:51-72 (SAMGRAPH_EMPTY_FEAT)
  * host (CPU) gather       — cpu_extraction.cc (OpenMP gather)

The interesting split is device-resident vs host-resident features; the
cache manager (fgnn_tpu.cache.manager) composes these into the miss/hit
merge of DoCacheFeatureCopy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def device_gather(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """output[i] = table[ids[i]]; padded ids (-1) produce zero rows."""
    safe = jnp.maximum(ids, 0)
    out = jnp.take(table, safe, axis=0)
    return jnp.where((ids >= 0)[:, None], out, 0)


def mock_gather(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """Empty-feat mode: index modulo fake table size (GPUMockExtract)."""
    n = table.shape[0]
    safe = jnp.maximum(ids, 0) % n
    out = jnp.take(table, safe, axis=0)
    return jnp.where((ids >= 0)[:, None], out, 0)


def host_gather(feat_mmap: np.ndarray, ids: np.ndarray,
                mod: int = 0) -> np.ndarray:
    """Host-side gather from the (mmap-backed) feature matrix.

    Uses the native OpenMP gather (fgnn_tpu.native, cpu_extraction.cc
    analog — ~5x NumPy) when built, NumPy otherwise. ``mod`` > 0 applies
    empty-feat modulo indexing (CPUMockExtract analog) — pass
    ``ds.feat_mod`` so mock datasets don't IndexError.
    """
    from .. import native

    if mod:
        ids = np.where(ids >= 0, ids % mod, ids)
    if native.available() and feat_mmap.dtype == np.float32:
        return native.gather_f32(feat_mmap, ids)
    safe = np.maximum(ids, 0)
    out = feat_mmap[safe]
    out[ids < 0] = 0
    return out


def label_gather(labels: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """DoGPULabelExtract analog: labels for the batch seeds; padded -> -1."""
    safe = jnp.maximum(ids, 0)
    out = jnp.take(labels, safe)
    return jnp.where(ids >= 0, out, -1)
