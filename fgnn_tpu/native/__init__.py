"""ctypes bindings for the native host runtime (libfgnn_host.so).

The shared object is built with ``make`` at first use, from the committed
sources, into ``build/libfgnn_host-<key>.so`` (gitignored). The key hashes
``fgnn_host.cpp``, the Makefile and the build host (the Makefile compiles
with -march=native), so a binary from another source tree or another
machine is never loaded: a changed source or a new host builds anew.
Falls back to NumPy implementations when the build fails. The native
paths matter at papers100M scale where the host feature gather is on the
critical path (reference: cpu_extraction.cc with OpenMP).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def lib_path() -> str:
    """Where the shared object for these sources on this host lives."""
    h = hashlib.sha256()
    for name in ("fgnn_host.cpp", "Makefile"):
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return os.path.join(_DIR, "build",
                        f"libfgnn_host-{h.hexdigest()[:16]}.so")


def _make(path: str) -> bool:
    """Build ``path``; the object appears there whole or not at all."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", _DIR, f"OUT={tmp}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, path)
    except (subprocess.SubprocessError, OSError):
        return False
    return True


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    path = lib_path()
    if not os.path.exists(path):
        if _build_attempted:
            return None
        _build_attempted = True
        if not _make(path):
            return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fgnn_gather_f32.argtypes = [f32p, i64, i64, i32p, i64, f32p]
    lib.fgnn_gather_f32_partial.argtypes = [f32p, i64, i64, i32p, i64, i64, f32p]
    lib.fgnn_count_freq.argtypes = [i32p, i64, i64, i64p]
    lib.fgnn_rank_desc.argtypes = [i64p, i64, i32p]
    lib.fgnn_sample_khop.argtypes = [
        i64p, i32p, i32p, i64, i64, ctypes.c_uint64,
        ctypes.c_int32, i32p,
    ]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.fgnn_sample_weighted_khop.argtypes = [
        i64p, i32p, f64p, i32p, i64, i64, ctypes.c_uint64,
        ctypes.c_int32, i32p,
    ]
    lib.fgnn_sample_random_walk.argtypes = [
        i64p, i32p, i32p, i64, i64, i64, ctypes.c_float, i64,
        ctypes.c_uint64, i32p, f32p,
    ]
    lib.fgnn_dedup_remap.argtypes = [
        i32p, i64, i32p, i64, i64, i32p, i32p,
    ]
    lib.fgnn_dedup_remap.restype = i64
    _lib = lib
    return lib


def available() -> bool:
    return _try_load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def gather_f32(table: np.ndarray, ids: np.ndarray,
               out: Optional[np.ndarray] = None,
               n_real: Optional[int] = None) -> np.ndarray:
    """out[i] = table[ids[i]] (parallel); ids<0 or i>=n_real -> zeros."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n, dim = len(ids), table.shape[1]
    if out is None:
        out = np.empty((n, dim), dtype=np.float32)
    lib = _try_load()
    if lib is None:
        real = n if n_real is None else n_real
        safe = np.maximum(ids[:real], 0)
        out[:real] = table[safe]
        out[:real][ids[:real] < 0] = 0
        out[real:] = 0
        return out
    if not (table.flags["C_CONTIGUOUS"] and table.dtype == np.float32):
        table = np.ascontiguousarray(table, dtype=np.float32)
    if n_real is None:
        lib.fgnn_gather_f32(
            _ptr(table, ctypes.c_float), table.shape[0], dim,
            _ptr(ids, ctypes.c_int32), n, _ptr(out, ctypes.c_float),
        )
    else:
        lib.fgnn_gather_f32_partial(
            _ptr(table, ctypes.c_float), table.shape[0], dim,
            _ptr(ids, ctypes.c_int32), n, n_real, _ptr(out, ctypes.c_float),
        )
    return out


def count_freq(ids: np.ndarray, num_nodes: int,
               counts: Optional[np.ndarray] = None) -> np.ndarray:
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    if counts is None:
        counts = np.zeros(num_nodes, dtype=np.int64)
    lib = _try_load()
    if lib is None:
        valid = ids[(ids >= 0) & (ids < num_nodes)]
        np.add.at(counts, valid, 1)
        return counts
    lib.fgnn_count_freq(
        _ptr(ids, ctypes.c_int32), len(ids), num_nodes,
        _ptr(counts, ctypes.c_int64),
    )
    return counts


def sample_khop(
    indptr: np.ndarray,
    indices: np.ndarray,
    inputs: np.ndarray,
    fanout: int,
    seed: int,
    replace: bool = False,
) -> Optional[np.ndarray]:
    """Threaded host khop sampling (cpu_sampling_khop0.cc analog).

    Returns [len(inputs), fanout] int32 neighbor picks (-1 padded), or
    None when the native library is unavailable or fanout > 256 (callers
    fall back to the NumPy reference sampler)."""
    lib = _try_load()
    if lib is None or fanout > 256 or not hasattr(lib, "fgnn_sample_khop"):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    inputs = np.ascontiguousarray(inputs, dtype=np.int32)
    out = np.empty((len(inputs), fanout), dtype=np.int32)
    lib.fgnn_sample_khop(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(inputs, ctypes.c_int32), len(inputs), fanout,
        ctypes.c_uint64(seed & (2**64 - 1)), ctypes.c_int32(int(replace)),
        _ptr(out, ctypes.c_int32),
    )
    return out


def sample_weighted_khop(
    indptr: np.ndarray,
    indices: np.ndarray,
    gcum: np.ndarray,
    inputs: np.ndarray,
    fanout: int,
    seed: int,
    dedup: bool = False,
) -> Optional[np.ndarray]:
    """Threaded weighted host sampling (cpu_sampling_weighted_khop.cc
    analog): inverse-CDF on the global edge-weight cumsum; ``dedup``
    gives the hash-dedup per-vertex-unique semantics. Returns
    [len(inputs), fanout] int32 (-1 padded) or None when unavailable."""
    lib = _try_load()
    if (lib is None or fanout > 256
            or not hasattr(lib, "fgnn_sample_weighted_khop")):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    gcum = np.ascontiguousarray(gcum, dtype=np.float64)
    inputs = np.ascontiguousarray(inputs, dtype=np.int32)
    out = np.empty((len(inputs), fanout), dtype=np.int32)
    lib.fgnn_sample_weighted_khop(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(gcum, ctypes.c_double), _ptr(inputs, ctypes.c_int32),
        len(inputs), fanout, ctypes.c_uint64(seed & (2**64 - 1)),
        ctypes.c_int32(int(dedup)), _ptr(out, ctypes.c_int32),
    )
    return out


def sample_random_walk(
    indptr: np.ndarray,
    indices: np.ndarray,
    inputs: np.ndarray,
    num_walk: int,
    walk_len: int,
    restart: float,
    topk: int,
    seed: int,
):
    """Threaded PinSAGE host sampling (cpu_sampling_random_walk.cc +
    FrequencyHashmap analog). Returns ([n, topk] int32 neighbors,
    [n, topk] f32 visit-count weights) or None when unavailable."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "fgnn_sample_random_walk"):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    inputs = np.ascontiguousarray(inputs, dtype=np.int32)
    nbr = np.empty((len(inputs), topk), dtype=np.int32)
    w = np.empty((len(inputs), topk), dtype=np.float32)
    lib.fgnn_sample_random_walk(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(inputs, ctypes.c_int32), len(inputs), num_walk, walk_len,
        ctypes.c_float(restart), topk,
        ctypes.c_uint64(seed & (2**64 - 1)),
        _ptr(nbr, ctypes.c_int32), _ptr(w, ctypes.c_float),
    )
    return nbr, w


def dedup_remap(cur: np.ndarray, nbr_flat: np.ndarray, cap: int):
    """CPUHashTable2-style dedup + remap (cpu_hashtable2.cc analog).

    ``cur`` is the padded frontier (valid entries keep their slots, -1
    holes allowed); ``nbr_flat`` the flat picks. Returns
    ``(unique [cap], n_new, src_local [len(nbr_flat)])`` in the
    hashtable-invariant layout (frontier-first, new nodes ascending) —
    bit-identical to the NumPy dense-table path but O(batch) memory.
    Returns None when the native library is unavailable."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "fgnn_dedup_remap"):
        return None
    cur = np.ascontiguousarray(cur, dtype=np.int32)
    nbr_flat = np.ascontiguousarray(nbr_flat, dtype=np.int32)
    unique = np.empty(cap, dtype=np.int32)
    src_local = np.empty(len(nbr_flat), dtype=np.int32)
    n_new = lib.fgnn_dedup_remap(
        _ptr(cur, ctypes.c_int32), len(cur),
        _ptr(nbr_flat, ctypes.c_int32), len(nbr_flat), cap,
        _ptr(unique, ctypes.c_int32), _ptr(src_local, ctypes.c_int32),
    )
    return unique, int(n_new), src_local


def rank_desc(counts: np.ndarray) -> np.ndarray:
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    lib = _try_load()
    if lib is None:
        return np.argsort(-counts, kind="stable").astype(np.int32)
    out = np.empty(len(counts), dtype=np.int32)
    lib.fgnn_rank_desc(_ptr(counts, ctypes.c_int64), len(counts),
                       _ptr(out, ctypes.c_int32))
    return out
