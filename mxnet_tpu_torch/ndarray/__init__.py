"""The ``nd`` namespace: ``NDArray``, the creation functions, ``save`` and
``load``, and one wrapper per registered op (and alias), which is also the
``F`` Gluon's ``hybrid_forward`` receives.

PyTorch counterpart of ``mxnet_tpu/ndarray/__init__.py``.  An op wrapper
called with any ``NDArray`` (or with ``out=``) dispatches through
:func:`ndarray.invoke` and returns NDArrays, as the reference's do; called
with ``torch.Tensor``s only (a block's ``hybrid_forward`` inside
``Block.__call__``) it runs the op on them and returns tensors.  An op that
takes ``_training`` gets ``autograd.is_training()`` unless the caller
passes it, as the reference's ``invoke`` does.

``save``/``load`` write and read the reference's two file formats, byte
for byte: the default ``"tpmx"`` and ``format="mxnet"`` (stock MXNet's).
A bfloat16 array is written from its raw 16-bit pattern under the dtype
name ``bfloat16`` (tpmx only: the MXNet format has no type flag for it).
"""
from __future__ import annotations

import inspect
import struct
import sys

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, dtype_name, torch_dtype
from ..ops import nn as _nn, tensor as _tensor  # noqa: F401  (registers)
from ..ops.registry import OP_REGISTRY
from .ndarray import NDArray, _device, array, invoke, waitall

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "save", "load", "waitall", "invoke"] + sorted(OP_REGISTRY)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", stype=None):
    if stype not in (None, "default"):
        raise MXNetError(f"storage type {stype!r} is not ported")
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """numpy's ``arange`` computed in float64 and cast, as the reference
    computes it."""
    out = torch.from_numpy(_np.arange(start, stop, step)).to(
        torch_dtype(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return NDArray(out.to(_device(ctx)))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    out = torch.from_numpy(_np.eye(int(N), int(M) if M else None, int(k)))
    return NDArray(out.to(torch_dtype(dtype)).to(_device(ctx)))


# ---------------------------------------------------------------------------
# op wrappers
# ---------------------------------------------------------------------------

def _make_wrapper(opname):
    op = OP_REGISTRY[opname]
    params = inspect.signature(op.fn).parameters
    takes_training = "_training" in params
    sig_params = [p.name for p in params.values()
                  if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                inspect.Parameter.KEYWORD_ONLY)
                  and p.name != "_training"]

    def _has_nd(args):
        return any(isinstance(a, NDArray) or (
            isinstance(a, (list, tuple)) and a and isinstance(a[0], NDArray))
            for a in args)

    def wrapper(*args, out=None, **kwargs):
        if out is None and not _has_nd(args):
            if takes_training:
                kwargs.setdefault("_training", autograd.is_training())
            return op.fn(*args, **kwargs)
        inputs, dev = [], None
        for a in args:
            if isinstance(a, NDArray):
                dev = dev or a._data.device
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], NDArray):
                inputs.extend(a)
            elif isinstance(a, (_np.ndarray, torch.Tensor)):
                inputs.append(NDArray(torch.as_tensor(a, device=dev)))
            elif i < len(sig_params):
                # a scalar attr passed positionally (nd.clip(x, 0, 6))
                if sig_params[i] in kwargs:
                    raise TypeError(f"{opname}: got multiple values for "
                                    f"argument {sig_params[i]!r}")
                kwargs[sig_params[i]] = a
            else:
                raise TypeError(f"{opname}: positional args must be "
                                f"NDArrays, got {type(a)}; pass attrs as "
                                f"keywords")
        return invoke(op, inputs, kwargs, out=out)

    wrapper.__name__ = opname
    wrapper.__doc__ = op.doc
    return wrapper


_this = sys.modules[__name__]   # not "_mod": that is an op's name
for _name in list(OP_REGISTRY):
    setattr(_this, _name, _make_wrapper(_name))
del _this, _name

add = broadcast_add                # noqa: F821 (generated above)
subtract = broadcast_sub           # noqa: F821
multiply = broadcast_mul           # noqa: F821
divide = broadcast_div             # noqa: F821
power = broadcast_power            # noqa: F821
maximum = broadcast_maximum        # noqa: F821
minimum = broadcast_minimum        # noqa: F821
equal = broadcast_equal            # noqa: F821
not_equal = broadcast_not_equal    # noqa: F821
greater = broadcast_greater        # noqa: F821
lesser = broadcast_lesser          # noqa: F821


# ---------------------------------------------------------------------------
# serialization (reference: mx.nd.save / mx.nd.load)
# ---------------------------------------------------------------------------

_NDARRAY_MAGIC = b"TPMX0001"


def _raw(a: NDArray):
    """(dtype name, shape, little-endian bytes) of an array; bfloat16 as
    its raw 16-bit pattern."""
    t = a._data.detach()
    name = dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.to("cpu", copy=True).contiguous().numpy()
    return name, tuple(t.shape), arr


def save(fname: str, data, format: str = "tpmx") -> None:
    """Save an NDArray, a list of them or a ``{name: NDArray}`` dict
    (reference: mx.nd.save); ``format="mxnet"`` writes stock MXNet's
    binary format, the default ``"tpmx"`` the reference's own."""
    if isinstance(data, NDArray):
        keys, arrays, kind = [""], [data], b"S"
    elif isinstance(data, dict):
        keys, arrays, kind = list(data), list(data.values()), b"D"
    else:
        keys, arrays, kind = ["" for _ in data], list(data), b"L"
    if format == "mxnet":
        from . import mxnet_format as _mxf

        values = []
        for a in arrays:
            name, _, arr = _raw(a)
            if name not in _mxf._DTYPE_TO_TYPE_FLAG:
                raise MXNetError(f"the MXNet format has no type flag for "
                                 f"{name}")
            values.append(arr)
        payload = _mxf.save_bytes(
            values, [k for k in keys if k] if kind == b"D" else [])
        with open(fname, "wb") as f:
            f.write(payload)
        return
    if format != "tpmx":
        raise ValueError(f"unknown save format {format!r}")
    out = [_NDARRAY_MAGIC, kind, struct.pack("<Q", len(arrays))]
    for k, a in zip(keys, arrays):
        kb = k.encode()
        name, shape, arr = _raw(a)
        dt = name.encode()
        raw = arr.tobytes()
        out += [struct.pack("<I", len(kb)), kb, struct.pack("<I", len(dt)),
                dt, struct.pack("<I", len(shape))]
        out += [struct.pack("<Q", s) for s in shape]
        out += [struct.pack("<Q", len(raw)), raw]
    with open(fname, "wb") as f:
        f.write(b"".join(out))


def _from_raw(buf: bytes, name: str, shape, dev) -> NDArray:
    if name == "bfloat16":
        t = torch.from_numpy(_np.frombuffer(buf, _np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(_np.frombuffer(buf, _np.dtype(name)).copy())
    return NDArray(t.reshape(shape).to(dev))


def load(fname: str, ctx=None):
    """Load a file of either format (detected by its magic), onto ``ctx``
    (default: the current context): an NDArray, a list or a dict, as it was
    saved (reference: mx.nd.load)."""
    dev = _device(ctx)
    with open(fname, "rb") as f:
        blob = f.read()
    if blob[:8] != _NDARRAY_MAGIC:
        from . import mxnet_format as _mxf

        if not _mxf.is_mxnet_format(blob[:8]):
            raise ValueError(f"{fname}: not a tpu-mx or MXNet NDArray file")
        values, keys = _mxf.load_bytes(blob)
        if any(isinstance(v, tuple) for v in values):
            raise MXNetError(f"{fname}: sparse arrays are not ported")
        arrays = [NDArray(torch.from_numpy(v).to(dev)) for v in values]
        return dict(zip(keys, arrays)) if keys else arrays
    kind, off = blob[8:9], 9

    def take(n):
        nonlocal off
        off += n
        return blob[off - n:off]

    (n,) = struct.unpack("<Q", take(8))
    keys, arrays = [], []
    for _ in range(n):
        (klen,) = struct.unpack("<I", take(4))
        keys.append(take(klen).decode())
        (dlen,) = struct.unpack("<I", take(4))
        name = take(dlen).decode()
        (ndim,) = struct.unpack("<I", take(4))
        shape = tuple(struct.unpack("<Q", take(8))[0] for _ in range(ndim))
        (rawlen,) = struct.unpack("<Q", take(8))
        arrays.append(_from_raw(take(rawlen), name, shape, dev))
    if kind == b"S":
        return arrays[0]
    if kind == b"D":
        return dict(zip(keys, arrays))
    return arrays
