"""Tensor ops: elementwise math and comparisons (with the
``broadcast_*``, ``elemwise_*``, ``_*`` and ``_*_scalar`` names the
reference's NDArray operators map to), ``where``, the reductions, sorting
(``sort``, ``argsort``, ``topk``, ``histogram``), the shape ops
(``reshape`` with the reference's special codes, ``transpose``, slicing
and slice assignment, ``split``, ``concat``, ``pad``, the ``broadcast_*``
shapes, ``depth_to_space``...), ``dot``/``batch_dot`` and the
``linalg_*`` family, the indexing ops (``take``, ``pick``, ``gather_nd``,
``scatter_nd``, ``Embedding``...), the ``Sequence*`` ops, the creation ops
(``_zeros``, ``_arange``...), ``cast`` and the identity family
(``BlockGrad``, ``make_loss``...).

PyTorch counterpart of ``mxnet_tpu/ops/tensor.py``, every op of it.
Comparisons return 0/1 in the first input's dtype, and index outputs
(``argmax``, ``argsort``, ``topk``) float32, as the reference's do.  The
reference computes integer and half-precision inputs where torch has no
kernel for them (``erfinv`` of int32, say): those ops compute in float32
and return the dtype the reference returns.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import alias, register

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

def _half(f):
    """``f`` computed in float32 for integer and half-precision input and
    returned in the reference's dtype (float32 for an integer, the input's
    own for a float), where torch's kernel would refuse the dtype."""
    def impl(x):
        if x.dtype in (torch.float32, torch.float64):
            return f(x)
        out = f(x.to(torch.float32))
        return out if not x.dtype.is_floating_point else out.to(x.dtype)

    return impl


def _int_kept(f):
    """``f`` for floats; integer input returned as it is (a copy): the
    rounding functions keep an integer as jnp does."""
    def impl(x):
        return f(x) if x.dtype.is_floating_point else x.clone()

    return impl


def _inexact(f):
    """``f`` with integer input taken as float32 (jnp's promotion)."""
    def impl(x):
        return f(x if x.dtype.is_floating_point else x.to(torch.float32))

    return impl


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


class _Relu(torch.autograd.Function):
    """``torch.relu`` with the reference's ``jnp.maximum(x, 0)`` gradient:
    1/2 at exactly 0.  It keeps the output (which the next layer holds
    anyway) and a bool mask of the zeros, not the input."""

    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y, x == 0)
        return y

    @staticmethod
    def backward(ctx, g):
        y, zero = ctx.saved_tensors
        return torch.where(zero, g * 0.5,
                           torch.ops.aten.threshold_backward(g, y, 0))


def relu(x):
    """``max(x, 0)`` as the reference's ``jnp.maximum``: at exactly 0 the
    gradient is 1/2 (``torch.relu`` gives 0 there, which a zero-bias
    convolution over blank image regions hits everywhere)."""
    if not x.requires_grad or not torch.is_grad_enabled():
        return torch.relu(x)
    return _Relu.apply(x)


_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": _inexact(torch.round),   # half to even; an integer is float32
    "round": _int_kept(torch.round),
    "ceil": _int_kept(torch.ceil),
    "floor": _int_kept(torch.floor),
    "trunc": _int_kept(torch.trunc),
    "fix": _int_kept(torch.trunc),
    "square": torch.square,
    "sqrt": _inexact(torch.sqrt),
    "rsqrt": _inexact(torch.rsqrt),
    "cbrt": _half(_cbrt),
    "rcbrt": _half(lambda x: 1.0 / _cbrt(x)),
    "exp": _inexact(torch.exp),
    "log": _inexact(torch.log),
    "log10": _inexact(torch.log10),
    "log2": _inexact(torch.log2),
    "log1p": _inexact(torch.log1p),
    "expm1": _inexact(torch.expm1),
    "sin": _inexact(torch.sin),
    "cos": _inexact(torch.cos),
    "tan": _inexact(torch.tan),
    "arcsin": _inexact(torch.arcsin),
    "arccos": _inexact(torch.arccos),
    "arctan": _inexact(torch.arctan),
    "sinh": _inexact(torch.sinh),
    "cosh": _inexact(torch.cosh),
    "tanh": _inexact(torch.tanh),
    "arcsinh": _inexact(torch.arcsinh),
    "arccosh": _inexact(torch.arccosh),
    "arctanh": _inexact(torch.arctanh),
    "degrees": _inexact(lambda x: x * (180.0 / math.pi)),
    "radians": _inexact(lambda x: x * (math.pi / 180.0)),
    "reciprocal": _inexact(torch.reciprocal),
    # exp(log|gamma|), as the reference computes it
    "gamma": _half(lambda x: torch.exp(torch.lgamma(x))),
    "gammaln": _half(torch.lgamma),
    "erf": _half(torch.erf),
    "erfinv": _half(torch.erfinv),
    "sigmoid": _inexact(torch.sigmoid),
    "relu": relu,
    "softsign": _inexact(F.softsign),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register(_name, differentiable=_name != "logical_not")(
        (lambda f: lambda x: f(x))(_f))


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("identity", aliases=("_copy", "stop_gradient_identity"))
def identity(x):
    """``x`` itself (the reference's ``_copy`` and
    ``stop_gradient_identity`` are this op: the gradient passes)."""
    return x


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(x):
    return x.detach()


@register("make_loss")
def make_loss_op(data, grad_scale=1.0, valid_thresh=0.0,
                 normalization="null"):
    """The identity marking a loss head (reference: make_loss.cc); the
    head's gradient is the incoming cotangent."""
    return data


@register("_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    return data


@register("cast", aliases=("Cast",))
def cast(x, dtype="float32"):
    """Convert to ``dtype``.  Floating point to an integer type truncates
    toward zero and saturates at the type's range, NaN giving 0 (XLA's
    convert, which the reference runs); torch's ``.to`` alone would wrap
    an out-of-range value."""
    dt = torch_dtype(dtype)
    if x.dtype.is_floating_point and not (dt.is_floating_point
                                          or dt.is_complex
                                          or dt == torch.bool):
        info = torch.iinfo(dt)
        lo, hi = float(info.min), float(info.max)
        x = torch.nan_to_num(x.double(), nan=0.0, posinf=hi,
                             neginf=lo).clamp(lo, hi)
    return x.to(dt)


@register("amp_cast")
def amp_cast(x, dtype="float32"):
    """The cast AMP inserts: ``cast`` under its own name, so that the
    casts a policy added can be told from a user's own."""
    return cast(x, dtype)


@register("clip")
def clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x.clone()   # nothing to clip (torch.clamp needs a bound)
    return torch.clamp(x, a_min, a_max)


# ---------------------------------------------------------------------------
# elementwise binary + broadcast (elemwise_binary_op*.cc, broadcast ops)
# ---------------------------------------------------------------------------

def _mod(a, b):
    """numpy/jnp mod: the sign of the divisor.  An integer modulo 0 is 0,
    as jnp computes it (the divisor 0 replaced by 1)."""
    if not a.dtype.is_floating_point and not (
            isinstance(b, torch.Tensor) and b.dtype.is_floating_point):
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.remainder(a, b)


def _hypot(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt in (torch.float32, torch.float64):
        return torch.hypot(a.to(dt), b.to(dt))
    out = torch.hypot(a.to(torch.float32), b.to(torch.float32))
    return out.to(dt) if dt.is_floating_point else out


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": _mod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": _hypot,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": lambda a, b: (a != 0) & (b != 0),
    "logical_or": lambda a, b: (a != 0) | (b != 0),
    "logical_xor": lambda a, b: (a != 0) ^ (b != 0),
}

_CMP = {"equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal", "logical_and", "logical_or", "logical_xor"}


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

# the reference's other spellings of three scalar ops
alias("_plus_scalar", "_add_scalar")
alias("_minus_scalar", "_sub_scalar")
alias("_rminus_scalar", "_rsub_scalar")


@register("add_n", aliases=("ElementWiseSum", "_grad_add_n"))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("_grad_add")
def grad_add(a, b):
    return a + b


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


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _int_acc(x):
    """Accumulator of an integer (or bool) sum or product, None for floats:
    the reference runs without 64-bit types, so signed integers and bool
    reduce in int32 and unsigned ones in uint32 (accumulated here in int64
    and wrapped to 32 bits)."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return None
    return torch.int64 if x.dtype in _UNSIGNED else torch.int32


def _narrow(r, x):
    return r.to(torch.uint32) if x.dtype in _UNSIGNED else r


def _sum(x, dim, keepdim):
    acc = _int_acc(x)
    if acc is None:
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return _narrow(torch.sum(x, dim=dim, keepdim=keepdim, dtype=acc), x)


def _mean(x, dim, keepdim):
    # an integer mean is float32, as the reference's (to_inexact)
    if _int_acc(x) is not None:
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    acc = _int_acc(x)
    r = x
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        r = torch.prod(r, dim=d, keepdim=keepdim, dtype=acc)
    return r if acc is None else _narrow(r, x)


register("sum", aliases=("sum_axis",))(_reduce(_sum))
register("mean")(_reduce(_mean))
register("max", aliases=("max_axis",))(_reduce(_amax))
register("min", aliases=("min_axis",))(_reduce(_amin))
register("prod")(_reduce(_prod))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    s = _reduce(_sum)
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


def _nan_to(x, fill):
    if not x.dtype.is_floating_point:
        return x
    return torch.where(torch.isnan(x), torch.full((), fill, dtype=x.dtype,
                                                  device=x.device), x)


register("nansum")(_reduce(lambda x, dim, keepdim: _sum(_nan_to(x, 0.0),
                                                       dim, keepdim)))
register("nanprod")(_reduce(lambda x, dim, keepdim: _prod(_nan_to(x, 1.0),
                                                         dim, keepdim)))


@register("_square_sum")
def square_sum(data, axis=None, keepdims=False):
    return _reduce(_sum)(torch.square(data), axis=axis, keepdims=keepdims)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(data.dtype)


def _sorted(x, axis, descending):
    """Stable sort along ``axis`` (None: the flattened array), ascending,
    then reversed for ``descending`` as the reference flips its ascending
    order (equal keys come out in reversed index order)."""
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = int(axis)
    r = torch.sort(x, dim=ax, stable=True)
    if descending:
        return r.values.flip(ax), r.indices.flip(ax)
    return r.values, r.indices


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    return _sorted(x, axis, not is_ascend)[0]


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True):
    return _sorted(x, axis, not is_ascend)[1].to(torch.float32)


@register("topk", differentiable=False,
          num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both"
          else 1)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) entries along
    ``axis`` (None: the flattened array) as ``lax.top_k`` orders them:
    equal values by rising index.  ``ret_typ`` is ``"indices"`` (float32),
    ``"value"``, ``"both"`` or ``"mask"`` (0/1 in ``x``'s dtype)."""
    xm = x.reshape(-1) if axis is None else x.movedim(int(axis), -1)
    r = torch.sort(xm, dim=-1, descending=not is_ascend, stable=True)
    vals, idx = r.values[..., :int(k)], r.indices[..., :int(k)]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter(-1, idx, 1)
        return mask.reshape(x.shape) if axis is None else \
            mask.movedim(-1, int(axis))
    if axis is not None:
        vals, idx = vals.movedim(-1, int(axis)), idx.movedim(-1, int(axis))
    idx = idx.to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


@register("histogram", num_outputs=2, differentiable=False)
def histogram(data, bin_cnt=10, range=None):
    """``(counts, edges)`` as ``jnp.histogram`` computes them: ``bin_cnt +
    1`` edges ``linspace(lo, hi)`` (lo, hi: ``range`` or the data's min and
    max), each value counted in the bin ``searchsorted(edges, v, right) -
    1``, the top edge in the last bin.  Counts are int32 (the reference
    runs without 64-bit types), edges float32."""
    x = data.reshape(-1)
    x = x if x.dtype.is_floating_point else x.to(torch.float32)
    n = int(bin_cnt)
    if range is not None:
        lo = torch.full((), float(range[0]), device=x.device)
        hi = torch.full((), float(range[1]), device=x.device)
    else:
        lo, hi = x.min().float(), x.max().float()
    steps = torch.arange(n + 1, device=x.device, dtype=torch.float32)
    # jnp.linspace: start + step * i, the last edge exactly ``hi``
    edges = lo + steps * ((hi - lo) / n)
    edges = torch.cat([edges[:-1], hi.reshape(1)]).to(x.dtype)
    b = torch.searchsorted(edges, x.contiguous(), right=True)
    b = torch.where(x == edges[-1], torch.full_like(b, n), b)
    counts = torch.bincount(b, minlength=n + 2)[1:n + 1]
    return counts.to(torch.int32), edges.to(torch.float32)


alias("_histogram", "histogram")


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


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, dim1=0, dim2=1):
    return x.transpose(int(dim1), int(dim2))


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


alias("_rnn_param_concat", "concat")


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
    over the last axis of ``a`` and the first of ``b``.  bfloat16 and
    float16 inputs accumulate in float32 and return float32, as the
    reference's ``preferred_element_type`` does.  A csr left operand (a
    variable bound with ``stype="csr"``) takes :func:`spatial.csr_dot`."""
    if not isinstance(a, torch.Tensor):
        from .spatial import csr_dot

        return csr_dot(a, b, transpose_a, transpose_b)
    if transpose_a and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_b and b.ndim > 1:
        b = b.transpose(-1, -2)
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.float(), b.float()
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


def _half_acc(a, b):
    """bfloat16/float16 operands as float32: the product accumulates and
    returns float32, as the reference's ``preferred_element_type``."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return a.float(), b.float()
    return a, b


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    a, b = _half_acc(a, b)
    return torch.matmul(a, b)


@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Kronecker product (reference: la_op khatri_rao)."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


# ---------------------------------------------------------------------------
# linear algebra (la_op.cc): plain torch, as the reference is plain XLA
# ---------------------------------------------------------------------------

@register("linalg_gemm2")
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    r = batch_dot(a, b, transpose_a, transpose_b)
    return r if alpha == 1.0 else alpha * r


@register("linalg_gemm")
def linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    """``alpha * op(A) op(B) + beta * C``."""
    return alpha * batch_dot(a, b, transpose_a, transpose_b) + beta * c


def _linalg_float(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@register("linalg_potrf")
def linalg_potrf(a):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(_linalg_float(a))


def _solve_tri(a, b, lower, transpose, right=False):
    """``op(A) X = B`` (``X op(A) = B`` when ``right``), A triangular,
    ``op(A) = A^T`` when ``transpose``."""
    if transpose:
        a, lower = a.transpose(-1, -2), not lower
    return torch.linalg.solve_triangular(a, b, upper=not lower,
                                         left=not right)


@register("linalg_trsm")
def linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    a, b = _linalg_float(a), _linalg_float(b)
    return alpha * _solve_tri(a, b, lower, transpose, right=rightside)


@register("linalg_trmm")
def linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A) B`` (``B op(A)`` when ``rightside``), A's
    triangle only."""
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = tri.transpose(-1, -2)
    return alpha * (torch.matmul(b, tri) if rightside else
                    torch.matmul(tri, b))


@register("linalg_syrk")
def linalg_syrk(a, transpose=False, alpha=1.0):
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


@register("linalg_potri")
def linalg_potri(a, lower=True):
    """``A^-T A^-1`` from the Cholesky factor A: ``(A A^T)^-1`` for a lower
    A, by two triangular solves as the reference does."""
    a = _linalg_float(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    inv_a = _solve_tri(a, eye, lower, False)
    return _solve_tri(a, inv_a, lower, True)


@register("linalg_gelqf", num_outputs=2)
def linalg_gelqf(a):
    """LQ factorization ``A = L Q`` with row-orthonormal Q, returned as
    ``(Q, L)``: QR of ``A^T`` with L's diagonal made positive."""
    a = _linalg_float(a)
    q, r = torch.linalg.qr(a.transpose(-1, -2), mode="reduced")
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    q = q * d[..., None, :]
    r = r * d[..., :, None]
    return q.transpose(-1, -2), r.transpose(-1, -2)


@register("linalg_syevd", num_outputs=2)
def linalg_syevd(a):
    """Symmetric eigendecomposition ``(U, L)``: ``U A = diag(L) U``,
    eigenvalues ascending."""
    w, v = torch.linalg.eigh(_linalg_float(a))
    return v.transpose(-1, -2), w


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    d = d if d.dtype.is_floating_point else d.to(torch.float32)
    return torch.sum(torch.log(d), dim=-1)


@register("linalg_makediag")
def linalg_makediag(a, offset=0):
    k = int(offset)
    n = a.shape[-1] + abs(k)
    return torch.diag_embed(a, offset=k) if n > 0 else \
        a.new_zeros(a.shape[:-1] + (0, 0))


@register("linalg_extractdiag")
def linalg_extractdiag(a, offset=0):
    return torch.diagonal(a, offset=int(offset), dim1=-2, dim2=-1)


@register("diag")
def diag(x, k=0):
    if x.ndim == 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, offset=int(k), dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# layers and losses written as tensor ops (matrix_op.cc, l2_normalization,
# smooth_l1, pad.cc)
# ---------------------------------------------------------------------------

@register("L2Normalization")
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        n = torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                 dim=1) + eps)
        return x / n.reshape((-1,) + (1,) * (x.ndim - 1))
    if mode == "channel":
        return x / torch.sqrt(torch.sum(torch.square(x), dim=1,
                                        keepdim=True) + eps)
    red = tuple(range(2, x.ndim))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True)
                          + eps)


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


@register("pad", aliases=("Pad",))
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``jnp.pad`` with the reference's ``pad_width`` (before, after per
    axis): ``constant``, ``edge`` or ``reflect`` (numpy's: the edge value
    not repeated)."""
    pw = [int(v) for v in pad_width]
    pairs = [(pw[i], pw[i + 1]) for i in range(0, len(pw), 2)]
    pairs += [(0, 0)] * (x.ndim - len(pairs))
    if mode == "constant":
        flat = [v for pr in reversed(pairs) for v in pr]
        return F.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise KeyError(mode)
    # torch pads only the trailing 1-3 dims of a batched tensor in these
    # modes: pad the padded dims trailing, with the rest folded in front
    dims = [d for d, pr in enumerate(pairs) if pr != (0, 0)]
    if not dims:
        return x.clone()
    lead = [d for d in range(x.ndim) if d not in dims]
    xt = x.permute(*lead, *dims)
    shp = xt.shape
    xt = xt.reshape((1, -1) + tuple(shp[len(lead):]))
    flat = [v for d in reversed(dims) for v in pairs[d]]
    tmode = "replicate" if mode == "edge" else "reflect"
    low = xt.dtype not in (torch.float32, torch.float64)
    out = F.pad(xt.float() if low else xt, flat, mode=tmode)
    out = out.to(x.dtype) if low else out
    out = out.reshape(tuple(shp[:len(lead)]) + tuple(out.shape[2:]))
    return out.permute(*np.argsort(lead + dims).tolist())


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# shapes, slices and indices (matrix_op.cc, ravel.cc, indexing_op.cc)
# ---------------------------------------------------------------------------

@register("slice_like")
def slice_like(x, like, axes=()):
    axes = tuple(axes) if axes else tuple(range(min(x.ndim, like.ndim)))
    sl = [slice(None)] * x.ndim
    for a in axes:
        sl[int(a)] = slice(0, like.shape[int(a)])
    return x[tuple(sl)]


def _slice_key(shape, begin, end, step):
    """The reference's ``_slice_index`` as an index for ``x[...] = v``.
    With a negative step anywhere (torch slices take none) every axis
    becomes an index tensor, combined as an outer product."""
    step = step if step else (1,) * len(begin)
    key = [slice(None if b is None else int(b),
                 None if e is None else int(e), int(st) if st else 1)
           for b, e, st in zip(begin, end, step)]
    if all(k.step > 0 for k in key):
        return tuple(key)
    key += [slice(None)] * (len(shape) - len(key))
    idx = [torch.tensor(list(range(n)[k]), dtype=torch.long)
           for n, k in zip(shape, key)]
    return torch.meshgrid(*idx, indexing="ij")


@register("_slice_assign")
def slice_assign(lhs, rhs, begin=(), end=(), step=()):
    out = lhs.clone()
    out[_slice_key(lhs.shape, begin, end, step)] = rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar")
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_slice_key(data.shape, begin, end, step)] = scalar
    return out


@register("ravel_multi_index", differentiable=False,
          aliases=("_ravel_multi_index",))
def ravel_multi_index(data, shape=None):
    """(ndim, N) indices to flat ids, in ``data``'s dtype."""
    dims = tuple(int(d) for d in shape)
    strides = [int(np.prod(dims[i + 1:])) for i in range(len(dims))]
    st = torch.tensor(strides, dtype=data.dtype, device=data.device)
    return torch.sum(data * st[:, None], dim=0).to(data.dtype)


@register("unravel_index", differentiable=False,
          aliases=("_unravel_index",))
def unravel_index(data, shape=None):
    """Flat ids to (ndim, N) indices, in ``data``'s dtype."""
    dims = tuple(int(d) for d in shape)
    rem = data.to(torch.int32).long()
    out = []
    for d in reversed(dims):
        out.append(rem % d)
        rem = rem // d
    return torch.stack(list(reversed(out)), dim=0).to(data.dtype)


@register("roll")
def roll(x, shift=0, axis=None):
    ax = _axis_arg(axis)
    sh = tuple(int(v) for v in shift) if isinstance(shift, (list, tuple)) \
        else int(shift)
    if ax is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, ax)


@register("shape_array", differentiable=False)
def shape_array(data):
    """The shape as int32 (the reference runs without 64-bit types)."""
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array", differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    target = list(x.shape)
    for a, n in zip(axis, size):
        target[int(a)] = int(n)
    return torch.broadcast_to(x, tuple(target))


def _wrap_clip(idx, n):
    """Negative indices from the end, then clamped into range (jnp's
    gather for ``x[idx]``)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1)


@register("gather_nd")
def gather_nd(data, indices):
    idx = indices.to(torch.int32).long()
    key = tuple(_wrap_clip(idx[i], data.shape[i])
                for i in range(idx.shape[0]))
    return data[key]


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (repeated
    indices accumulate, as ``.at[].add``)."""
    out = torch.zeros(tuple(int(v) for v in shape), dtype=data.dtype,
                      device=data.device)
    idx = indices.to(torch.int32).long()
    key = tuple(idx[i] for i in range(idx.shape[0]))
    return out.index_put(key, data, accumulate=True)


@register("batch_take")
def batch_take(a, indices):
    idx = _wrap_clip(indices.to(torch.int32).long(), a.shape[1])
    return torch.gather(a, 1, idx[:, None]).squeeze(1)


# ---------------------------------------------------------------------------
# creation (init_op.cc): on ``ctx``, else the current context
# ---------------------------------------------------------------------------

def _ctx_device(ctx):
    from ..ndarray.ndarray import _device

    return _device(ctx)


def _shape_arg(shape):
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(v) for v in shape)


@register("_zeros", differentiable=False)
def zeros_op(shape=(), dtype="float32", ctx=None):
    return torch.zeros(_shape_arg(shape), dtype=torch_dtype(dtype),
                       device=_ctx_device(ctx))


@register("_ones", differentiable=False)
def ones_op(shape=(), dtype="float32", ctx=None):
    return torch.ones(_shape_arg(shape), dtype=torch_dtype(dtype),
                      device=_ctx_device(ctx))


@register("_full", differentiable=False)
def full_op(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(_shape_arg(shape), value, dtype=torch_dtype(dtype),
                      device=_ctx_device(ctx))


@register("_eye", differentiable=False)
def eye_op(N=0, M=0, k=0, dtype="float32", ctx=None):
    out = torch.from_numpy(np.eye(int(N), int(M) if M else None, int(k)))
    return out.to(torch_dtype(dtype)).to(_ctx_device(ctx))


@register("_arange", differentiable=False)
def arange_op(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
              ctx=None, infer_range=False):
    """numpy's ``arange`` computed in float64 and cast, as the reference
    computes it."""
    out = torch.from_numpy(np.arange(start, stop, step)).to(
        torch_dtype(dtype))
    if int(repeat) != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out.to(_ctx_device(ctx))


@register("take")
def take(a, indices, axis=0, mode="clip"):
    ax = int(axis) % a.ndim
    n = a.shape[ax]
    idx = indices.to(torch.int32).long()
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN for floats, the
    least value of a signed integer, the largest of an unsigned one."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if dtype in _UNSIGNED else info.min


@register("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Reference: src/operator/tensor/indexing_op.cc Embedding: rows of
    ``weight`` gathered by ``data`` (cast to int32), as ``jnp.take``
    gathers them: an index in ``[-n, 0)`` counts from the end, any other
    index out of range gives a row of the fill value (NaN for floats).
    The gradient is a dense scatter-add (none to a filled row)."""
    n = weight.shape[0]
    idx = data.to(torch.int32).long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = weight.index_select(0, idx.clamp(0, n - 1).reshape(-1)).reshape(
        tuple(idx.shape) + tuple(weight.shape[1:]))
    fill = torch.full((), _fill_value(weight.dtype), dtype=weight.dtype,
                      device=weight.device)
    return torch.where(valid.reshape(valid.shape + (1,) * (weight.ndim - 1)),
                       rows, fill)


def _lengths(sequence_length):
    return sequence_length.to(torch.int32).long()


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value`` (time on
    ``axis`` 0 or 1, the batch on the other)."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[int(axis)], device=data.device)
    lens = _lengths(sequence_length)
    if int(axis) == 0:
        mask = steps[:, None] < lens[None, :]
    else:
        mask = steps[None, :] < lens[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    ax = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, data.shape[ax] - 1)
    idx = _lengths(sequence_length) - 1
    shape = ((1, -1) if ax == 0 else (-1, 1)) + (1,) * (data.ndim - 2)
    idx = idx.reshape(shape).expand(
        *(1 if d == ax else data.shape[d] for d in range(data.ndim)))
    return torch.gather(data, ax, idx).squeeze(ax)


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed along axis 0, the
    padding left in place (the whole axis flipped without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (int(axis),))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = _lengths(sequence_length)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (data.ndim - 2))
    return torch.gather(data, 0, rev.expand(*data.shape))


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
