"""raindrop_tpu_torch: the PyTorch and CUDA port of the JAX package.

Serves Raindrop v2 on an NVIDIA H100 through hand-written CUDA kernels
(csrc/) for the temporal encoder. The JAX package `raindrop_tpu` is the
reference it is tested against; this package imports nothing of it.
"""

from raindrop_tpu_torch.config import DATASETS, RaindropConfig, dataset_config

__all__ = ["DATASETS", "RaindropConfig", "dataset_config"]
