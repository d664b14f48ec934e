"""Tensor ops the Gluon blocks and losses call: the elementwise
arithmetic the losses use (with the ``broadcast_*``, ``_*`` and
``_*_scalar`` names the reference's NDArray operators map to), ``where``,
the reductions ``sum``/``mean`` and ``norm``, ``reshape_like``, ``pick``,
``flatten``/``Flatten`` and ``transpose``.

PyTorch counterpart of ``mxnet_tpu/ops/tensor.py`` (only these ops so
far).  Comparisons return 0/1 in the first input's dtype, as the
reference's do.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["where", "norm", "reshape_like", "pick", "flatten", "transpose"]


def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


# ---------------------------------------------------------------------------
# elementwise unary (reference: src/operator/tensor/elemwise_unary_op_basic.cc)
# ---------------------------------------------------------------------------

_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "square": torch.square,
    "log": torch.log,
    "relu": torch.relu,
}

for _name, _f in _UNARY.items():
    register(_name)((lambda f: lambda x: f(x))(_f))


# ---------------------------------------------------------------------------
# elementwise binary + broadcast (elemwise_binary_op*.cc, broadcast ops)
# ---------------------------------------------------------------------------

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "equal": torch.eq,
    "greater": torch.gt,
}

_CMP = {"equal", "greater"}


def _binary_impl(f, cmp):
    def impl(a, b):
        r = f(a, b)
        return r.to(a.dtype) if cmp else r   # the reference keeps a's dtype

    return impl


for _name, _f in _BINARY.items():
    # elemwise_* wants equal shapes in the reference and broadcast_*
    # broadcasts; torch broadcasts, so one function serves both names
    register("elemwise_" + _name, differentiable=_name not in _CMP,
             aliases=("broadcast_" + _name, "_" + _name))(
        _binary_impl(_f, _name in _CMP))

for _name, _f in _BINARY.items():
    register("_" + _name + "_scalar", differentiable=_name not in _CMP)(
        (lambda impl: lambda x, scalar=0.0: impl(
            x, torch.tensor(scalar, dtype=x.dtype, device=x.device)))(
            _binary_impl(_f, _name in _CMP)))


@register("_rsub_scalar")
def _rsub_scalar(x, scalar=0.0):
    return torch.tensor(scalar, dtype=x.dtype, device=x.device) - x


@register("where")
def where(cond, x, y):
    return torch.where(cond != 0, x, y)


# ---------------------------------------------------------------------------
# reductions (broadcast_reduce_op*.cc)
# ---------------------------------------------------------------------------

def _reduce(fn):
    def impl(x, axis=None, keepdims=False, exclude=False):
        ax = _axis_arg(axis)
        if isinstance(ax, int):
            ax = (ax,)
        if exclude and ax is not None:
            ax = tuple(i for i in range(x.ndim) if i not in
                       {a % x.ndim for a in ax})
        if ax is None:
            ax = tuple(range(x.ndim))
        elif not ax:
            return x   # an empty axis list reduces nothing
        return fn(x, dim=ax, keepdim=bool(keepdims))

    return impl


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    s = _reduce(torch.sum)
    if ord == 1:
        return s(torch.abs(x), axis=axis, keepdims=keepdims)
    return torch.sqrt(s(torch.square(x), axis=axis, keepdims=keepdims))


@register("reshape_like")
def reshape_like(x, y):
    return x.reshape(y.shape)


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x``'s entries at ``index`` along ``axis`` (the index truncated to
    an integer, then wrapped or clipped into range)."""
    ax = int(axis) % x.ndim
    n = x.shape[ax]
    idx = index.to(torch.int32).long()
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    idx = idx.unsqueeze(ax)
    idx = idx.expand(*(1 if d == ax else x.shape[d] for d in range(x.ndim)))
    r = torch.gather(x, ax, idx)
    return r if keepdims else r.squeeze(ax)


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
