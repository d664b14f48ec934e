"""Tensor ops the Gluon blocks call: the elementwise add of a residual,
``flatten``/``Flatten`` and ``transpose``.

PyTorch counterpart of ``mxnet_tpu/ops/tensor.py`` (only these ops so far).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["elemwise_add", "flatten", "transpose"]


@register("elemwise_add", aliases=("broadcast_add", "_add"))
def elemwise_add(a, b):
    """Elementwise (broadcasting) sum."""
    return torch.add(a, b)


@register("flatten", aliases=("Flatten",))
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def transpose(x, axes=None):
    """Permute the axes (reversed when ``axes`` is empty): a view, as the
    reference leaves the physical layout to XLA."""
    if axes is None or len(axes) == 0:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*(int(a) for a in axes))
