"""The device a measurement runs on, as every result reports it."""
from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu() -> list:
    """JAX's devices; exits non-zero unless the first one is a GPU. A
    measurement never falls back to another platform."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX's first device is {devs[0].platform} "
            f"({devs[0].device_kind})"
        )
    return devs


def device_summary() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power() -> str:
    """Name and power limit of each card, one line per card, from
    nvidia-smi in a child process (which stays off JAX)."""
    r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip()
