"""fgnn_tpu — factored sample-based GNN training framework in JAX.

A from-scratch JAX/XLA re-design of GNNLab/FGNN
(SJTU-IPADS/fgnn-artifacts, EuroSys'22) that runs on NVIDIA GPUs:
factored sampler/trainer device roles over a device mesh, a
pre-sampling-ranked device feature cache, and mask-aware message passing.
See SURVEY.md for the blueprint.
"""

__version__ = "0.1.0"

from .config import CachePolicy, RunArch, RunConfig, SampleType
from .data import Dataset, load_dataset, make_synthetic_dataset, write_dataset

__all__ = [
    "CachePolicy",
    "Dataset",
    "RunArch",
    "RunConfig",
    "SampleType",
    "load_dataset",
    "make_synthetic_dataset",
    "write_dataset",
]
