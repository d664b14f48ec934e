"""Operators of the port: the op registry with the ops Gluon's blocks call
(``nn``, ``tensor``), the hand-written CUDA kernels (built from ``csrc/``
at first use) with their plain PyTorch versions, and the token-sampling
functions of the generation engine; the 2-bit gradient compression
kernels (``twobit``)."""
from . import (batch_norm, flash_attention, layer_norm, nn, paged_attention,
               registry, sampling, tensor, twobit)

__all__ = ["batch_norm", "flash_attention", "layer_norm", "nn",
           "paged_attention", "registry", "sampling", "tensor", "twobit"]
