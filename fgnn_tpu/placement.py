"""Feature placement: whether the feature table lives in device memory.

The engines keep the whole feature table on the device when it fits in
``feat_budget`` bytes, and otherwise leave it on the host behind the
feature cache (or the host gather). The budget is the device's memory
limit, less the on-device graph, less a fixed share of headroom for
everything else the training step allocates.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

# FGNN_TPU_FEAT_HBM_BUDGET=<bytes> overrides the derived budget; 0 forces
# host-resident features (the cache and host-gather paths)
ENV_FEAT_BUDGET = "FGNN_TPU_FEAT_HBM_BUDGET"

# share of the device memory limit kept free for activations, parameters
# and optimizer state, and XLA's scratch space
HEADROOM_FRAC = 0.25


def feat_budget(graph_bytes: int, device=None) -> Optional[int]:
    """Bytes the feature table may take on ``device`` (default: the
    first device). None when the device reports no memory limit (the
    CPU backend): features then always stay on the device."""
    env = os.environ.get(ENV_FEAT_BUDGET)
    if env is not None:
        return int(env)
    device = jax.devices()[0] if device is None else device
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        return None
    return max(0, int(limit * (1.0 - HEADROOM_FRAC)) - graph_bytes)


def features_fit(feat_bytes: int, budget: Optional[int]) -> bool:
    return budget is None or feat_bytes <= budget
