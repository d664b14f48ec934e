"""Tensor ops: elementwise arithmetic and comparisons (with the
``broadcast_*``, ``elemwise_*``, ``_*`` and ``_*_scalar`` names the
reference's NDArray operators map to), ``where``, the reductions, the
shape ops (``reshape`` with the reference's special codes, ``transpose``,
``expand_dims``, ``squeeze``, slicing, ``split``, ``concat``, ``stack``,
``tile``, ``repeat``, ``flip``, the ``broadcast_*`` shapes), ``dot``,
``take``/``pick``/``one_hot``, ``cast`` and the ``*_like`` fills.

PyTorch counterpart of ``mxnet_tpu/ops/tensor.py`` (only these ops so
far).  Comparisons return 0/1 in the first input's dtype, and
``argmax``/``argmin`` float32 indices, as the reference's do.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["where", "norm", "reshape", "reshape_like", "pick", "flatten",
           "transpose"]


def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _scalar_like(x, scalar):
    return torch.tensor(scalar, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# elementwise unary (reference: src/operator/tensor/elemwise_unary_op_basic.cc)
# ---------------------------------------------------------------------------

_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "sign": torch.sign,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
}

for _name, _f in _UNARY.items():
    register(_name)((lambda f: lambda x: f(x))(_f))


@register("cast", aliases=("Cast",))
def cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


# ---------------------------------------------------------------------------
# elementwise binary + broadcast (elemwise_binary_op*.cc, broadcast ops)
# ---------------------------------------------------------------------------

def _mod(a, b):
    return torch.remainder(a, b)   # numpy/jnp mod: the sign of the divisor


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": _mod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}

_CMP = {"equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal"}


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
        (lambda impl: lambda x, scalar=0.0: impl(x, _scalar_like(x, scalar)))(
            _binary_impl(_f, _name in _CMP)))

for _name in ("sub", "div", "power", "mod"):
    register("_r" + _name + "_scalar")(
        (lambda f: lambda x, scalar=0.0: f(_scalar_like(x, scalar), x))(
            _BINARY[_name]))


@register("where")
def where(cond, x, y):
    return torch.where(cond != 0, x, y)


# ---------------------------------------------------------------------------
# reductions (broadcast_reduce_op*.cc)
# ---------------------------------------------------------------------------

def _axes(x, axis, exclude=False):
    ax = _axis_arg(axis)
    if isinstance(ax, int):
        ax = (ax,)
    if exclude and ax is not None:
        ax = tuple(i for i in range(x.ndim) if i not in
                   {a % x.ndim for a in ax})
    return tuple(range(x.ndim)) if ax is None else ax


def _reduce(fn):
    def impl(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(x, axis, exclude)
        if not ax:
            return x   # an empty axis list reduces nothing
        return fn(x, dim=ax, keepdim=bool(keepdims))

    return impl


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean))
register("max", aliases=("max_axis",))(_reduce(_amax))
register("min", aliases=("min_axis",))(_reduce(_amin))
register("prod")(_reduce(_prod))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    s = _reduce(torch.sum)
    if ord == 1:
        return s(torch.abs(x), axis=axis, keepdims=keepdims)
    return torch.sqrt(s(torch.square(x), axis=axis, keepdims=keepdims))


def _arg(fn):
    def impl(x, axis=None, keepdims=False):
        ax = _axis_arg(axis)
        if ax is None:
            r = fn(x.reshape(-1), dim=0)
        else:
            r = fn(x, dim=ax, keepdim=bool(keepdims))
        return r.to(torch.float32)

    return impl


register("argmax", differentiable=False)(_arg(torch.argmax))
register("argmin", differentiable=False)(_arg(torch.argmin))


# ---------------------------------------------------------------------------
# matrix ops (matrix_op.cc: reshape/transpose/slice/...; dot.cc)
# ---------------------------------------------------------------------------

def _reshape_target(src, shape):
    """The reference's special codes, left to right: 0 keeps a dim, -1
    infers one, -2 copies the rest, -3 merges two, -4 splits one in two."""
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return out


@register("reshape", aliases=("Reshape",))
def reshape(x, shape=None, reverse=False):
    """``x`` in ``shape``, with the reference's special codes (0, -1, -2,
    -3, -4; ``reverse`` reads both shapes from the right)."""
    shape = tuple(int(s) for s in shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return x.reshape(shape)
    src = list(x.shape)
    if reverse:
        rev, fixed, j = list(reversed(shape)), [], 0
        while j < len(rev):
            if j + 2 < len(rev) and rev[j + 2] == -4:
                fixed.extend([-4, rev[j + 1], rev[j]])
                j += 3
            else:
                fixed.append(rev[j])
                j += 1
        return x.reshape(tuple(_reshape_target(src[::-1], fixed)[::-1]))
    return x.reshape(tuple(_reshape_target(src, list(shape))))


@register("reshape_like")
def reshape_like(x, y):
    return x.reshape(y.shape)


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


@register("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(int(axis))


@register("squeeze")
def squeeze(x, axis=None):
    ax = _axis_arg(axis)
    if ax is None:
        return x.squeeze()
    return x.squeeze(ax)


@register("slice", aliases=("crop",))
def slice_op(x, begin=None, end=None, step=None):
    begin, end, step = begin or (), end or (), step or ()
    sl = []
    for i in range(len(begin)):
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] not in (None, 0) else 1
        sl.append(slice(begin[i], e, s))
    return _index(x, tuple(sl))


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    sl = [slice(None)] * x.ndim
    sl[int(axis)] = slice(begin, end)
    return x[tuple(sl)]


def _index(x, key):
    """``x[key]`` with numpy's negative steps (torch slices take none)."""
    key = key if isinstance(key, tuple) else (key,)
    flips, norm_key = [], []
    for d, k in enumerate(key):
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            idx = torch.tensor(list(range(x.shape[d])[k]), device=x.device,
                               dtype=torch.long)
            norm_key.append(idx)
            flips.append(d)
        else:
            norm_key.append(k)
    if not flips:
        return x[tuple(key)]
    for d in flips:   # one gather per reversed axis
        x = x.index_select(d, norm_key[d])
        norm_key[d] = slice(None)
    return x[tuple(norm_key)]


@register("concat", aliases=("Concat",))
def concat(*args, dim=1):
    return torch.cat(args, dim=int(dim))


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=int(axis))


@register("split", aliases=("SliceChannel",),
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    ax = int(axis)
    n = int(num_outputs)
    if x.shape[ax] % n:
        raise ValueError(f"split: axis {ax} of size {x.shape[ax]} is not "
                         f"divisible into {n} parts")
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


@register("tile")
def tile(x, reps=()):
    return torch.tile(x, tuple(int(r) for r in reps))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    ax = _axis_arg(axis)
    if ax is None:
        return torch.repeat_interleave(x.reshape(-1), int(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=ax)


@register("flip", aliases=("reverse",))
def flip(x, axis=0):
    ax = _axis_arg(axis)
    return torch.flip(x, (ax,) if isinstance(ax, int) else ax)


@register("broadcast_to")
def broadcast_to(x, shape=()):
    target = tuple(int(s) if int(s) != 0 else x.shape[i]
                   for i, s in enumerate(shape))
    return torch.broadcast_to(x, target)


@register("broadcast_like")
def broadcast_like(x, like):
    return torch.broadcast_to(x, like.shape)


@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    """numpy's ``dot`` (reference: src/operator/tensor/dot.cc): a sum
    over the last axis of ``a`` and the first of ``b``."""
    if transpose_a and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_b and b.ndim > 1:
        b = b.transpose(-1, -2)
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register("take")
def take(a, indices, axis=0, mode="clip"):
    ax = int(axis) % a.ndim
    n = a.shape[ax]
    idx = indices.to(torch.int32).long()
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


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


@register("one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    idx = indices.to(torch.int32).long()
    hit = (idx.unsqueeze(-1) == torch.arange(int(depth), device=idx.device))
    oh = hit.to(torch.float32)
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)
