"""Optimizer update rules (reference: src/operator/optimizer_op.cc).

PyTorch counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.  Each rule
updates its weight and state tensors in place (the reference's fused op
convention, where the JAX package returns new arrays instead) and returns
them.  They are plain elementwise torch ops: the reference writes them as
XLA code, not as Pallas kernels.  Gradients are rescaled by
``rescale_grad`` and clipped to ``+-clip_gradient`` when it is ``>= 0``.
Call them under ``torch.no_grad()`` for leaves that require grad.

Each rule is also registered as the reference's op (``sgd_update``...,
``_sparse_adagrad_update`` on dense input): the op runs the rule on
copies of the weight and the states and returns the new ones (weight
first), leaving its inputs as they were, as the reference's pure
functions do.  ``ftrl_update`` and ``ftml_update`` exist only as such
ops: no optimizer class runs them in place.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "signsgd_update", "signum_update",
           "sparse_adagrad_update"]


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


def _ftrl(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
          rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


def _ftml(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
          epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    g = _rescale_clip(grad * rescale_grad + wd * weight, 1.0, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


def sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad on dense input (a row of zero gradient changes nothing)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    history.add_(torch.square(g))
    weight.sub_(lr * g / (torch.sqrt(history) + epsilon))
    return weight, history


def _as_op(name, rule, num_outputs):
    """Register ``rule`` as the op ``name`` over copies of its inputs
    (the gradient, second, is read only); an integer weight or state is
    copied as float32, the dtype the reference's arithmetic gives it."""
    def fresh(t):
        return t.clone() if t.dtype.is_floating_point else \
            t.to(torch.float32)

    def op(weight, grad, *states, **attrs):
        return rule(fresh(weight), grad, *[fresh(st) for st in states],
                    **attrs)

    op.__doc__ = rule.__doc__
    register(name, num_outputs=num_outputs)(op)


for _name, _rule, _n in (
        ("sgd_update", sgd_update, 1),
        ("sgd_mom_update", sgd_mom_update, 2),
        ("mp_sgd_update", mp_sgd_update, 2),
        ("mp_sgd_mom_update", mp_sgd_mom_update, 3),
        ("adam_update", adam_update, 3),
        ("rmsprop_update", rmsprop_update, 2),
        ("rmspropalex_update", rmspropalex_update, 4),
        ("signsgd_update", signsgd_update, 1),
        ("signum_update", signum_update, 2),
        ("_sparse_adagrad_update", sparse_adagrad_update, 2)):
    _as_op(_name, _rule, _n)

# these two compute new tensors (their rules read the old weight after
# the new one is known), so their ops are the pure functions themselves
register("ftrl_update", num_outputs=3)(_ftrl)
register("ftml_update", num_outputs=4)(_ftml)
