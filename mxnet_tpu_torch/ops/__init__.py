"""Operators of the port: the op registry with the ops Gluon's blocks and
NDArrays call (``nn``, ``tensor``), the hand-written CUDA kernels (built
from ``csrc/``, at first use) with their plain PyTorch versions, the
token-sampling functions of the generation engine, the 2-bit gradient
compression kernels (``twobit``) and the optimizers' update rules
(``optimizer_ops``)."""
from . import (batch_norm, flash_attention, layer_norm, nn, optimizer_ops,
               paged_attention, registry, sampling, tensor, twobit)

__all__ = ["batch_norm", "flash_attention", "layer_norm", "nn",
           "optimizer_ops", "paged_attention", "registry", "sampling",
           "tensor", "twobit"]
