"""Operators of the port: the op registry with the ops Gluon's blocks and
NDArrays call (``nn``, ``tensor``), the hand-written CUDA kernels (built
from ``csrc/``, at first use) with their plain PyTorch versions, the
token-sampling functions of the generation engine, the random samplers
(``random_ops``, bit for bit the reference's threefry draws), the fused
recurrent ``RNN`` op (``rnn``, plain torch), the 2-bit gradient
compression kernels (``twobit``) and the optimizers' update rules
(``optimizer_ops``, also registered as ops), the legacy ``Crop`` and
``SVMOutput`` with the grid sampler, spatial transformer, correlation
and the OpenCV-style helpers (``spatial``), the flash attention op, the
box, ROI, deformable and CTC ops (``contrib``), the SSD and RPN ops
(``detection``), the image ops (``image_ops``), the int8 quantization ops
(``quantization_ops``) and the user-defined op ``Custom`` (``custom``,
over ``mx.operator``'s registry)."""
from . import (batch_norm, contrib, custom, detection, flash_attention,
               image_ops, layer_norm, nn, optimizer_ops, paged_attention,
               quantization_ops, random_ops, registry, rnn, sampling, spatial,
               tensor, twobit)

__all__ = ["batch_norm", "contrib", "custom", "detection", "flash_attention",
           "image_ops", "layer_norm", "nn", "optimizer_ops",
           "paged_attention", "quantization_ops", "random_ops", "registry",
           "rnn", "sampling", "spatial", "tensor", "twobit"]
