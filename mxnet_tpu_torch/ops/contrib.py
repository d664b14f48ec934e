"""Contrib ops (PyTorch counterpart of ``mxnet_tpu/ops/contrib.py``; only
``_contrib_flash_attention`` so far, the rest is ROADMAP.md Queue 1,
item 6).

``flash_attention`` over (B, T, H, D) goes to
:func:`ops.flash_attention.flash_attention`: on CUDA tensors its forward
launches the flash forward kernel and its backward the dQ and dK/dV
kernels; CPU tensors take their plain versions.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .registry import register

__all__ = ["contrib_flash_attention"]


@register("_contrib_flash_attention", aliases=("flash_attention",))
def contrib_flash_attention(q, k, v, causal=False, scale=None):
    """Attention over (B, T, H, D) q, k, v (``causal`` masks the future;
    ``scale`` defaults to ``1/sqrt(D)``)."""
    from .nn import attr_bool

    return flash_attention(q, k, v, attr_bool(causal),
                           None if scale is None else float(scale))
