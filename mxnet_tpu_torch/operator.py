"""User-defined operators, ``mx.operator`` (PyTorch counterpart of
``mxnet_tpu/operator.py``; reference: python/mxnet/operator.py
``CustomOp``/``CustomOpProp``/``register``).

A registered op runs the user's Python ``forward`` and ``backward`` on
NDArrays.  It is the graph op ``Custom`` (``op_type`` names the
registered prop; its other attributes go to the prop's constructor), so
one function serves every layer (the op itself is ``ops/custom.py``):

- eagerly, ``nd.Custom(x, op_type=...)``: the body runs at the call; under
  ``autograd.record()`` the op is a ``torch.autograd.Function`` whose
  backward calls the user's ``backward``;
- symbolically, ``sym.Custom(...)``: the executor runs the body at the
  node, the same Function carrying the gradient; the shape solver (meta
  tensors) takes the output shapes from ``CustomOpProp.infer_shape`` and
  runs no body;
- in a hybridized block: the body syncs with the host (``asnumpy``), so
  a program that runs a ``Custom`` op is never captured as a CUDA graph.
  Its warm-up sees the op, and the program runs uncaptured from then on,
  counted in ``gluon.cached_op.UNCAPTURED`` and logged once.

Arrays the body makes (``nd.array(...)``) land on the current context;
:meth:`CustomOp.assign` moves them to the destination's device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as _np
import torch

from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_CUSTOM_REGISTRY: Dict[str, type] = {}


class CustomOp:
    """Base class of a user op's body (reference: operator.py
    CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src):
        """Write ``src`` into ``dst`` as ``req`` asks: ``"write"`` (or
        ``"inplace"``) replaces, ``"add"`` adds, ``"null"`` does nothing;
        ``src`` (an NDArray, a tensor or anything numpy takes) is moved
        to ``dst``'s device."""
        if req in ("null", None):
            return
        if isinstance(src, NDArray):
            t = src._data
        elif isinstance(src, torch.Tensor):
            t = src
        else:
            t = torch.from_numpy(_np.ascontiguousarray(_np.asarray(src)))
        t = t.detach().to(dst._data.device)
        if req == "add":
            dst._data = dst._data + t
        else:
            dst._data = t


class CustomOpProp:
    """A user op's metadata and factory (reference: operator.py
    CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Class decorator registering a :class:`CustomOpProp` subclass as
    ``op_type=reg_name`` of ``nd.Custom`` and ``sym.Custom``."""

    def do_register(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered_operators() -> List[str]:
    return list(_CUSTOM_REGISTRY)
