"""Build/install fgnn_tpu.

The native extension (fgnn_tpu/native) is optional: a C++/OpenMP host
runtime for the hot host-side paths (parallel feature gather from mmap,
frequency counting), built with make at first use (fgnn_tpu/native);
pure-NumPy fallbacks keep everything working without it.
"""
from setuptools import find_packages, setup

setup(
    name="fgnn_tpu",
    version="0.1.0",
    description=(
        "Factored sample-based GNN training framework for GPUs "
        "(GNNLab/FGNN capabilities, JAX/XLA)"
    ),
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
)
