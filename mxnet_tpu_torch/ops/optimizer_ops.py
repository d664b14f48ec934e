"""Optimizer update rules (reference: src/operator/optimizer_op.cc).

PyTorch counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.  Each rule
updates its weight and state tensors in place (the reference's fused op
convention, where the JAX package returns new arrays instead) and returns
them.  They are plain elementwise torch ops: the reference writes them as
XLA code, not as Pallas kernels.  Gradients are rescaled by
``rescale_grad`` and clipped to ``+-clip_gradient`` when it is ``>= 0``.
Call them under ``torch.no_grad()`` for leaves that require grad.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "signsgd_update", "signum_update"]


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights >= 0:
        w.clamp_(-clip_weights, clip_weights)


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (g + wd * weight))
    return weight


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)
    return weight, mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD: float32 master weights ``weight32``, the
    low-precision ``weight`` their rounded copy."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    weight32.sub_(lr * (g + wd * weight32))
    weight.copy_(weight32)
    return weight, weight32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight, mom, weight32


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _rescale_clip(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight, mean, var


def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _rescale_clip(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(g))
    weight.sub_(lr * g / torch.sqrt(n + epsilon))
    _clip_weights(weight, clip_weights)
    return weight, n


def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _rescale_clip(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(gr))
    g.copy_(gamma1 * g + (1 - gamma1) * gr)
    delta.copy_(gamma2 * delta - lr * gr / torch.sqrt(
        n - torch.square(g) + epsilon))
    weight.add_(delta)
    _clip_weights(weight, clip_weights)
    return weight, n, g, delta


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * weight))
    return weight


def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1 - momentum) * (g + wd * weight))
    weight.copy_((1 - lr * wd_lh) * weight + lr * torch.sign(mom))
    return weight, mom
