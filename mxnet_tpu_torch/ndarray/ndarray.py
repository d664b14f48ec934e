"""NDArray: the imperative tensor.

PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An ``NDArray``
is a mutable handle over one ``torch.Tensor`` (``_data``).  Two rules keep
the reference's value semantics on mutable torch storage:

- Every op returns a tensor of its own: a result that would share storage
  with an input (a reshape, a slice, ``detach``, a cast to the same dtype)
  is copied, so a later write to the input never shows in it.
- Writes (in-place operators, ``__setitem__``, ``out=``, ``copyto``, a
  kvstore pull, an optimizer update) write into the handle's tensor in
  place.  A Gluon ``Parameter``'s handle wraps the block's own
  ``nn.Parameter``, so an update through it is the block's weight.

Gradients are torch autograd, gated at this boundary: an op builds a graph
only inside ``autograd.record()`` (torch's grad mode is set from the
recording flag for the op and restored after it), so outside it nothing is
recorded, as in the reference.  ``attach_grad`` makes the tensor a leaf
that requires grad and marks it for ``autograd.backward``.

``dtype`` is a numpy dtype; bfloat16, which numpy lacks, is the string
``"bfloat16"``, and ``asnumpy`` refuses it (``astype("float32")`` first).
``waitall``/``wait_to_read`` synchronize the card.
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, context_of, current_context, resolve_device
from ..ops.registry import Op, get_op

__all__ = ["NDArray", "invoke", "array", "waitall"]


_TAKES_TRAINING = {}


def _accepts_training(op: Op) -> bool:
    cached = _TAKES_TRAINING.get(op.name)
    if cached is None:
        try:
            cached = "_training" in inspect.signature(op.fn).parameters
        except (TypeError, ValueError):
            cached = False
        _TAKES_TRAINING[op.name] = cached
    return cached


def _storage(t):
    return t.untyped_storage().data_ptr() if t.numel() else None


def _own(r, inputs):
    """``r``, copied if it shares storage with any of ``inputs``."""
    p = _storage(r)
    if p is not None and any(_storage(i) == p for i in inputs):
        return r.clone()
    return r


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data: torch.Tensor):
        self._data = data
        self._grad: Optional["NDArray"] = None
        self._grad_req: Optional[str] = None

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    # -- host sync ----------------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        if self._data.dtype == torch.bfloat16:
            raise MXNetError("numpy has no bfloat16: call "
                             "astype(\"float32\") before asnumpy()")
        return self._data.detach().to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Block until the value is computed (reference: WaitToRead)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self._data.reshape(()).item())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- conversion / movement ----------------------------------------------
    def astype(self, dtype, copy=True):
        return invoke(get_op("cast"), [self], {"dtype": dtype})

    def as_in_context(self, ctx) -> "NDArray":
        dev = resolve_device(ctx)
        if dev.type == self._data.device.type and (
                dev.index is None or dev.index == self._data.device.index):
            return self
        with torch.set_grad_enabled(_recording()):
            return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other) -> "NDArray":
        """Copy into another NDArray (in place) or onto a context
        (reference: CopyFromTo)."""
        if isinstance(other, NDArray):
            other._write(self._data)
            return other
        if isinstance(other, (Context, str, torch.device)):
            dev = resolve_device(other)
            return NDArray(self._data.detach().to(dev, copy=True))
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    # -- writes -------------------------------------------------------------
    def _write(self, value) -> None:
        """Write ``value`` (a tensor, broadcast to this shape) into this
        handle's tensor in place; a leaf that requires grad is written
        outside the graph, anything else differentiably under record()."""
        d = self._data
        if isinstance(value, torch.Tensor) and value.shape != d.shape:
            try:
                value = torch.broadcast_to(value, d.shape)
            except RuntimeError as e:
                raise MXNetError(
                    f"cannot assign array of shape {tuple(value.shape)} to "
                    f"NDArray of shape {tuple(d.shape)}") from e
        with torch.set_grad_enabled(_recording() and not (
                d.requires_grad and d.is_leaf)):
            d.copy_(value)

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate a gradient buffer and mark this array as a variable of
        ``autograd.backward`` (reference: autograd.mark_variables)."""
        from .. import autograd

        grad = NDArray(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [grad], grad_reqs=[grad_req])

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], head_grads=None if out_grad is None
                          else [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- shape manipulation -------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if "shape" in kwargs:
            shape = kwargs["shape"]
        return invoke(get_op("reshape"), [self], {"shape": tuple(shape)})

    def reshape_like(self, other):
        return invoke(get_op("reshape_like"), [self, other], {})

    def transpose(self, axes=None):
        return invoke(get_op("transpose"), [self], {"axes": axes or ()})

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return invoke(get_op("flatten"), [self], {})

    def expand_dims(self, axis):
        return invoke(get_op("expand_dims"), [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke(get_op("squeeze"), [self], {"axis": axis})

    def broadcast_to(self, shape):
        return invoke(get_op("broadcast_to"), [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return invoke(get_op("broadcast_like"), [self, other], {})

    def flip(self, axis):
        return invoke(get_op("flip"), [self], {"axis": axis})

    def tile(self, reps):
        return invoke(get_op("tile"), [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke(get_op("repeat"), [self],
                      {"repeats": repeats, "axis": axis})

    def swapaxes(self, dim1, dim2):
        axes = list(range(self.ndim))
        axes[dim1], axes[dim2] = axes[dim2], axes[dim1]
        return self.transpose(axes)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke(get_op("split"), [self],
                      {"num_outputs": num_outputs, "axis": axis,
                       "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        return invoke(get_op("slice"), [self],
                      {"begin": begin, "end": end, "step": step})

    def slice_axis(self, axis, begin, end):
        return invoke(get_op("slice_axis"), [self],
                      {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke(get_op("take"), [self, self._like(indices)],
                      {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kwargs):
        return invoke(get_op("one_hot"), [self], dict(depth=depth, **kwargs))

    # -- reductions and elementwise -----------------------------------------
    def _reduce(self, name, axis, keepdims):
        return invoke(get_op(name), [self],
                      {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke(get_op("norm"), [self],
                      {"ord": ord, "axis": axis, "keepdims": keepdims})

    def _unary(self, name, **attrs):
        return invoke(get_op(name), [self], attrs)

    def abs(self):
        return self._unary("abs")

    def sqrt(self):
        return self._unary("sqrt")

    def square(self):
        return self._unary("square")

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def sigmoid(self):
        return self._unary("sigmoid")

    def tanh(self):
        return self._unary("tanh")

    def relu(self):
        return self._unary("relu")

    def sign(self):
        return self._unary("sign")

    def softmax(self, axis=-1):
        return self._unary("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._unary("log_softmax", axis=axis)

    def clip(self, a_min=None, a_max=None):
        return self._unary("clip", a_min=a_min, a_max=a_max)

    def zeros_like(self):
        return self._unary("zeros_like")

    def ones_like(self):
        return self._unary("ones_like")

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke(get_op("dot"), [self, self._like(other)],
                      {"transpose_a": transpose_a,
                       "transpose_b": transpose_b})

    def _like(self, x) -> "NDArray":
        """``x`` as an NDArray on this array's device."""
        if isinstance(x, NDArray):
            return x
        return NDArray(torch.as_tensor(np.asarray(x),
                                       device=self._data.device))

    # -- arithmetic operators -----------------------------------------------
    def _binary(self, opname, other, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op("broadcast_" + opname), [a, b], {})
        scalar = float(other)
        if reverse and opname in ("sub", "div", "power", "mod"):
            return invoke(get_op(f"_r{opname}_scalar"), [self],
                          {"scalar": scalar})
        return invoke(get_op(f"_{opname}_scalar"), [self], {"scalar": scalar})

    def __add__(self, other):
        return self._binary("add", other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary("sub", other)

    def __rsub__(self, other):
        return self._binary("sub", other, reverse=True)

    def __mul__(self, other):
        return self._binary("mul", other)

    __rmul__ = __mul__

    def __matmul__(self, other):
        return self.dot(other)

    def __truediv__(self, other):
        return self._binary("div", other)

    def __rtruediv__(self, other):
        return self._binary("div", other, reverse=True)

    def __mod__(self, other):
        return self._binary("mod", other)

    def __rmod__(self, other):
        return self._binary("mod", other, reverse=True)

    def __pow__(self, other):
        return self._binary("power", other)

    def __rpow__(self, other):
        return self._binary("power", other, reverse=True)

    def __neg__(self):
        return self._unary("negative")

    def __abs__(self):
        return self._unary("abs")

    def __eq__(self, other):
        if other is None:
            return NDArray(torch.zeros_like(self._data.detach()))
        return self._binary("equal", other)

    def __ne__(self, other):
        if other is None:
            return NDArray(torch.ones_like(self._data.detach()))
        return self._binary("not_equal", other)

    def __gt__(self, other):
        return self._binary("greater", other)

    def __ge__(self, other):
        return self._binary("greater_equal", other)

    def __lt__(self, other):
        return self._binary("lesser", other)

    def __le__(self, other):
        return self._binary("lesser_equal", other)

    def __hash__(self):
        return id(self)

    # in place: the result is written into this handle's tensor.  Under
    # record(), writing a marked variable raises (the reference forbids
    # in-place ops on recorded arrays); torch itself refuses, at backward,
    # a write to a tensor the graph saved.
    def _inplace(self, opname, other):
        from .. import autograd

        autograd.check_inplace(self)
        self._write(self._binary(opname, other)._data)
        return self

    def __iadd__(self, other):
        return self._inplace("add", other)

    def __isub__(self, other):
        return self._inplace("sub", other)

    def __imul__(self, other):
        return self._inplace("mul", other)

    def __itruediv__(self, other):
        return self._inplace("div", other)

    # -- indexing -----------------------------------------------------------
    def _convert_key(self, key):
        if isinstance(key, NDArray):
            k = key._data
            return k if k.dtype == torch.bool else k.to(torch.long)
        if isinstance(key, tuple):
            return tuple(self._convert_key(k) for k in key)
        if isinstance(key, (list, np.ndarray)):
            k = torch.as_tensor(np.asarray(key), device=self._data.device)
            return k if k.dtype == torch.bool else k.to(torch.long)
        return key

    def __getitem__(self, key):
        from ..ops.tensor import _index

        with torch.set_grad_enabled(_recording()):
            r = _index(self._data, self._convert_key(key))
            return NDArray(_own(r, [self._data]))

    def __setitem__(self, key, value):
        from .. import autograd

        autograd.check_inplace(self)
        d = self._data
        if isinstance(value, NDArray):
            v = value._data
        elif isinstance(value, (int, float, bool)):
            v = value
        else:
            v = torch.as_tensor(np.asarray(value), dtype=d.dtype,
                                device=d.device)
        k = self._convert_key(key)
        with torch.set_grad_enabled(_recording() and not (
                d.requires_grad and d.is_leaf)):
            try:
                d[k] = v
            except RuntimeError as e:
                raise MXNetError(f"cannot assign to NDArray of shape "
                                 f"{tuple(d.shape)} at {key!r}: {e}") from e

    def __repr__(self):
        if self._data.dtype == torch.bfloat16:
            body = str(self._data.detach().float().cpu().numpy())
        else:
            body = str(self.asnumpy())
        return (f"\n{body}\n<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _recording() -> bool:
    from .. import autograd

    return autograd.is_recording()


# ---------------------------------------------------------------------------
# op dispatch (reference: Imperative::Invoke)
# ---------------------------------------------------------------------------

def invoke(op: Op, inputs: Sequence[NDArray], attrs: dict, out=None):
    """Run ``op`` on the inputs' tensors, building a graph only under
    ``autograd.record()``; wrap the results (each of its own storage), or
    write them into ``out``."""
    from .. import autograd

    vals = [i._data for i in inputs]
    kwargs = dict(attrs)
    if _accepts_training(op):
        kwargs.setdefault("_training", autograd.is_training())
    try:
        with torch.set_grad_enabled(autograd.is_recording()):
            result = op.fn(*vals, **kwargs)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(f"operator {op.name} failed: {e}") from e
    multi = isinstance(result, (tuple, list))
    results = [_own(r, vals) for r in (result if multi else [result])]
    if out is not None:
        outs = out if isinstance(out, (tuple, list)) else [out]
        for dst, r in zip(outs, results):
            autograd.check_inplace(dst)
            dst._write(r)
        return out
    outputs = [NDArray(r) for r in results]
    return tuple(outputs) if multi else outputs[0]


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _device(ctx) -> torch.device:
    return resolve_device(ctx if ctx is not None else current_context())


def array(source, ctx=None, dtype=None) -> NDArray:
    """A new NDArray holding a copy of ``source`` (an NDArray, a tensor or
    anything numpy takes) on ``ctx`` (default: the current context);
    float64 input without a ``dtype`` becomes float32."""
    dev = _device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach().to(dev, copy=True)
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t)
    want = None if dtype is None else torch_dtype(dtype)
    src = np.asarray(source)
    if want is None and src.dtype == np.float64:
        src = src.astype(np.float32)
    t = torch.tensor(src, device=dev)   # a copy (src may be read-only)
    if want is not None:
        t = t.to(want)
    return NDArray(t)


def waitall():
    """Block until all outstanding work on the card completes
    (reference: Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
