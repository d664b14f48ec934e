"""Operators of the port: the hand-written CUDA kernels (built from
``csrc/`` at first use) with their plain PyTorch versions, and the
token-sampling functions of the generation engine."""
from . import flash_attention, layer_norm, paged_attention, sampling

__all__ = ["flash_attention", "layer_norm", "paged_attention", "sampling"]
