"""The legacy ``Crop`` op and the ``SVMOutput`` loss head.

PyTorch counterpart of ``mxnet_tpu/ops/spatial.py`` (only these two ops
so far; the grid sampler, spatial transformer, correlation and the rest
are ROADMAP.md Queue 1, item 6).  ``SVMOutput``'s backward is its own (a
``torch.autograd.Function``), the reference's custom vjp: the L1 or L2
hinge gradient, whatever the incoming cotangent.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["crop_legacy", "svm_output"]


@register("Crop")
def crop_legacy(*args, offset=(0, 0), h_w=(0, 0), center_crop=False,
                num_args=1):
    """The spatial dims (NCHW) of ``data`` cropped to ``h_w``, or to those
    of a second ``crop_like`` input, from ``offset`` (or centred with
    ``center_crop``) (reference: src/operator/crop-inl.h)."""
    data = args[0]
    if len(args) >= 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


def _svm_grad(data, label, margin, reg_coef, use_linear):
    """The hinge gradient of each row of ``data`` (flattened past the
    batch axis) against its integer label: L1-SVM's subgradient with
    ``use_linear``, else L2-SVM's (reference: svm_output.cc:31-66)."""
    x = data.reshape(data.shape[0], -1)
    k = label.reshape(-1).to(torch.int32).long()
    onehot = (k[:, None] == torch.arange(x.shape[1], device=x.device)).to(
        x.dtype)
    if use_linear:
        at_k = -(margin > x).to(x.dtype) * reg_coef
        rest = (margin > -x).to(x.dtype) * reg_coef
    else:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        at_k = -reg_coef * torch.where(margin > x, 2.0 * (margin - x), zero)
        rest = -reg_coef * torch.where(margin > -x, -2.0 * (margin + x),
                                       zero)
    return (onehot * at_k + (1.0 - onehot) * rest).reshape(data.shape)


class _SVMOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        ctx.save_for_backward(data, label)
        ctx.cfg = cfg
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return _svm_grad(data, label, *ctx.cfg), None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Hinge-loss output head: the forward is the identity, the backward
    the L1/L2 SVM gradient."""
    from .nn import attr_bool

    cfg = (float(margin), float(regularization_coefficient),
           attr_bool(use_linear))
    return _SVMOutputFn.apply(data, label, cfg)
