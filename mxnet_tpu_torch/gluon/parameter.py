"""Gluon Parameter / ParameterDict.

PyTorch counterpart of ``mxnet_tpu/gluon/parameter.py``: a ``Parameter``
with a deferred shape, ``grad_req`` and ``data()``/``grad()``, and a
``ParameterDict`` with prefix scoping and sharing; ``cast`` and the
symbolic variable ``var()``.

A Parameter's tensor is an ``nn.Parameter`` (``requires_grad`` unless
``grad_req == "null"``) registered on every block that holds it as an
attribute, under that attribute's name, so ``block.parameters()`` and
``block.state_dict()`` see it.  ``data()`` is an ``NDArray`` over that
``nn.Parameter`` itself (``_data``; ``None`` until initialized), so an
optimizer's in-place update through it is the block's weight, and
``grad()`` the ``NDArray`` that ``autograd.backward`` writes
(``grad_req="write"``) or adds to (``"add"``).  The block's forward reads
the tensor the block currently holds (:meth:`Parameter._tensor`), so a
``torch.func.functional_call`` that substitutes the block's tensors is
seen by its ``hybrid_forward``.  Writes a layer makes to its state in the
forward (BatchNorm's running statistics) go through
:meth:`Parameter._assign`: in place outside a functional call, and, inside
one (``parallel.data_parallel.block_train_fn``), into the substituted slot
and a record the caller returns as ``new_aux``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import torch

from .. import autograd, initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import context_of, resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict",
           "capture_writes"]

_tls = threading.local()


class capture_writes:
    """Context manager: state writes made by layers in the forward are
    recorded by parameter name in ``self.writes`` and applied to the
    block's current (substituted) slot only, never in place."""

    def __enter__(self):
        self._old = getattr(_tls, "writes", None)
        self.writes = {}
        _tls.writes = self.writes
        return self

    def __exit__(self, *exc):
        _tls.writes = self._old


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._var: Optional[torch.nn.Parameter] = None
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init = None
        self._ctx_list = []
        self._owners = []   # (block, attribute name)
        self._symvar = None

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}: "
                             "expected write/add/null")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._var is not None:
            self._var.requires_grad_(req != "null")
            self._init_grad()

    def _shape_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Allocate and initialize on ``ctx`` (a ``Context``, a torch
        device or its name; ``None`` is ``cuda``), drawing from
        ``generator``; with an unknown shape and ``allow_deferred_init``,
        wait for the first forward."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._var is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        device = resolve_device(ctx)
        self._ctx_list = [context_of(device)]
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init, generator)
                return
            raise MXNetError(
                f"cannot initialize {self.name}: unknown shape {self.shape}; "
                "set allow_deferred_init or pass in_units/in_channels")
        self._finish_init(init, device, default_init, generator)

    def _finish_init(self, init, device, default_init, generator):
        self._deferred_init = None
        arr = torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                          device=device)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        initializer(init_mod.InitDesc(self.name), arr, generator)
        self._set_var(torch.nn.Parameter(
            arr, requires_grad=self._grad_req != "null"))

    def _set_var(self, var):
        self._var = var
        if self._data is None:
            self._data = NDArray(var)
        else:   # keep the handle: callers may hold it
            self._data._data = var
        for block, attr in self._owners:
            block._parameters[attr] = var
        self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer, marked for ``autograd.backward`` (none
        for ``grad_req="null"``)."""
        if self._grad_req == "null":
            self._grad = None
            return
        self._grad = NDArray(torch.zeros_like(self._var.detach()))
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=[self._grad_req])

    def _bind(self, block, attr):
        """Register this parameter's tensor on ``block`` as ``attr``."""
        self._owners.append((block, attr))
        if self._var is not None:
            block._parameters[attr] = self._var

    def _finish_deferred_init(self, shape):
        if self._deferred_init is None:
            raise DeferredInitializationError(self.name)
        self.shape = tuple(shape)
        init, device, default_init, generator = self._deferred_init
        self._finish_init(init, device, default_init, generator)

    def _check_init(self):
        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred; run a forward pass "
                    f"first")
            raise MXNetError(
                f"parameter {self.name} has not been initialized")

    def data(self, ctx=None) -> NDArray:
        """The parameter's ``NDArray`` (over its ``nn.Parameter``)."""
        self._check_init()
        return self._data

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        self._check_init()
        return list(self._ctx_list)

    def _tensor(self) -> torch.Tensor:
        """The tensor the owning block currently holds (the one a
        functional call substituted, inside one)."""
        self._check_init()
        if self._owners:
            block, attr = self._owners[0]
            return block._parameters[attr]
        return self._var

    def set_data(self, data):
        """Copy ``data`` (an NDArray, tensor or array of the parameter's
        shape) into the parameter, in its dtype and on its device."""
        if self._var is None:
            if self._deferred_init is not None:
                self._finish_deferred_init(tuple(data.shape))
            else:
                raise MXNetError(f"parameter {self.name} not initialized")
        if tuple(data.shape) != tuple(self.shape):
            raise MXNetError(
                f"set_data for {self.name}: shape {tuple(data.shape)} "
                f"incompatible with parameter shape {tuple(self.shape)}")
        if isinstance(data, NDArray):
            data = data._data
        with torch.no_grad():
            self._var.copy_(torch.as_tensor(data))

    def _assign(self, value):
        """A layer's state write in the forward (see the module doc)."""
        writes = getattr(_tls, "writes", None)
        if writes is None:
            with torch.no_grad():
                self._tensor().copy_(value)
            return
        writes[self.name] = value
        for block, attr in self._owners:
            block._parameters[attr] = value

    def cast(self, dtype):
        """Cast to ``dtype``: a new tensor (and a new zero gradient buffer)
        of the cast values, registered on every owner; a captured program
        that held the old storage is built again."""
        self._symvar = None
        self.dtype = dtype
        if self._var is not None:
            self._set_var(torch.nn.Parameter(
                self._var.detach().to(torch_dtype(dtype)),
                requires_grad=self._grad_req != "null"))

    def var(self):
        """The parameter's ``Symbol`` variable (full name, shape, dtype,
        ``lr_mult``/``wd_mult``), cached so a shared block contributes one
        node (reference: ``Parameter.var``)."""
        if getattr(self, "_symvar", None) is None:
            from .. import symbol as sym

            self._symvar = sym.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult)
        return self._symvar

    def grad(self, ctx=None) -> NDArray:
        """The gradient ``NDArray`` that ``autograd.backward`` writes
        (``grad_req="write"``) or adds to (``"add"``)."""
        if self._grad is None:
            raise MXNetError(f"parameter {self.name} has no gradient "
                             f"(grad_req={self._grad_req})")
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data.zero_()


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join(repr(p) for p in self._params.values())
        return f"ParameterDict(prefix={self._prefix!r})\n{s}"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs) -> Parameter:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if v is None:
                continue
            existing = getattr(param, k, None)
            if k == "shape":
                v = (v,) if isinstance(v, int) else tuple(v)
                if existing is None:
                    param.shape = v
                    continue
                existing = tuple(existing)
                if len(existing) != len(v) or any(
                        a and b and a != b for a, b in zip(existing, v)):
                    raise AssertionError(
                        f"parameter {name} shape mismatch: existing "
                        f"{existing} vs requested {v}")
                param.shape = tuple(a if a else b
                                    for a, b in zip(existing, v))
            elif existing is None:
                setattr(param, k, v)
            elif k in ("init",):
                pass  # differing initializer hints keep the first one
            elif existing != v:
                raise AssertionError(
                    f"parameter {name} {k} mismatch: existing {existing!r} "
                    f"vs requested {v!r}")
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        if init is None:
            init = init_mod.Uniform()
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()
