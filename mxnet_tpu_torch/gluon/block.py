"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

PyTorch counterpart of ``mxnet_tpu/gluon/block.py``: ``name_scope`` and
the reference's prefix counting (``_BlockScope``: per-hint counters per
enclosing block, one global counter per hint for root blocks, and no
prefix of their own for ``prefix=""`` blocks), ``collect_params``,
``initialize``, deferred parameter shapes resolved on the first call, and
``hybrid_forward(F, x, **params)`` with ``F`` the op namespace
(``mxnet_tpu_torch.ndarray``).  Children are the module's submodules and
parameters its ``nn.Parameter``s (see ``gluon.parameter``), so
``parameters()``, ``state_dict()``, ``to()`` and
``torch.func.functional_call`` work on any block.

Calling a block with ``NDArray`` inputs (the imperative Gluon path) runs
its forward on their tensors with torch's grad mode set from
``autograd.is_recording()``, and wraps the outputs as NDArrays; called
with tensors (a parent block's forward, ``block_train_fn``'s functional
call) it is a plain ``torch.nn.Module`` call that returns tensors.

``save_parameters``/``load_parameters`` use the reference's file and keys
(the dotted structural names of ``_collect_params_with_prefix``, with the
full-name fallback on load), so a file written by either package loads
into the other.

``hybridize()`` is accepted and recorded, and the block keeps running
eagerly: cached programs (CUDA graphs, ``torch.compile``) are later work.

:func:`params_from_jax` fills a block's parameters from the reference's
``{name: array}`` (its ``collect_params()`` values, or the dicts its
``block_train_fn`` returns), names keyed with each root block's own prefix
stripped.
"""
from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch

from .. import autograd, ndarray as _F
from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "params_from_jax"]


class _NameManager:
    """Per-thread counters naming root blocks (reference: name.py
    NameManager: ``hint`` + its count so far)."""
    _tls = threading.local()

    @classmethod
    def get(cls, hint):
        counter = cls._tls.__dict__.setdefault("counter", {})
        hint = hint.lower()
        idx = counter.get(hint, 0)
        counter[hint] = idx + 1
        return f"{hint}{idx}"


class _BlockScope:
    _tls = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._tls, "current", None)
        if current is None:
            if prefix is None:
                prefix = _NameManager.get(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._tls, "current", None)
        _BlockScope._tls.current = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._tls.current = self._old_scope


class Block(torch.nn.Module):
    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._bind(self, name)

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self.add_module(name, block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on ``ctx`` (a torch device or its
        name; ``None`` is ``cuda``), drawing from ``generator``."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in
                   list(args) + list(kwargs.values())):
            return super().__call__(*args, **kwargs)
        args = [_unwrap(a) for a in args]
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            out = super().__call__(*args, **kwargs)
        return _wrap(out)

    # -- parameter files ----------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """``{dotted structural name: Parameter}`` (reference keys)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter under its dotted structural name in the
        reference's default file format."""
        _F.save(filename, {k: p.data() for k, p in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of either package's ``save_parameters`` (or of full
        parameter names, as ``export`` writes them) into this block;
        parameters not yet initialized are initialized on ``ctx``."""
        loaded = _F.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and params and not all(k in loaded for k in params):
            stripped = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
            if all(p.name in stripped for p in params.values()):
                loaded = {key: stripped[p.name]
                          for key, p in params.items()}
        for name, p in params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError(f"parameter {name} missing in "
                                     f"{filename}")
                continue
            if p._var is None:
                p.shape = tuple(loaded[name].shape)
                p.initialize(ctx=ctx)
            p.set_data(loaded[name])
        if not ignore_extra:
            for name in loaded:
                if name not in params:
                    raise MXNetError(f"parameter {name} in file not in "
                                     f"Block")


def _unwrap(a):
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, (list, tuple)):
        return type(a)(_unwrap(x) for x in a)
    return a


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(x) for x in out)
    return out


class HybridBlock(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        """Recorded (``_active``, ``_flags``); the block runs eagerly."""
        self._active = active
        self._flags = kwargs
        super().hybridize(active, **kwargs)

    def _infer_param_shapes(self, args):
        """Resolve deferred parameter shapes from the input shapes
        (subclasses give ``_param_shape``)."""
        for p in self._reg_params.values():
            if p._var is None and p._deferred_init is not None:
                p._finish_deferred_init(self._param_shape(p, args))

    def _param_shape(self, param, args):
        raise DeferredInitializationError(
            f"{self.name}: cannot infer shape for {param.name}")

    def forward(self, x, *args, **kwargs):
        params = {}
        for name, p in self._reg_params.items():
            try:
                params[name] = p._tensor()
            except DeferredInitializationError:
                self._infer_param_shapes((x,) + args)
                params[name] = p._tensor()
        return self.hybrid_forward(_F, x, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _reference_root(keys, suffixes):
    """The root prefix of the reference's names: the "_"-ended common
    prefix (shortest first) that leaves exactly ``suffixes``; when none
    does, the one leaving the fewest differences (for the error)."""
    common = os.path.commonprefix(keys)
    cands = [""] + [common[:i + 1] for i, ch in enumerate(common)
                    if ch == "_"]

    def diff(c):
        return len({k[len(c):] for k in keys} ^ suffixes)

    for c in cands:
        if diff(c) == 0:
            return c
    return min(cands, key=diff)


def params_from_jax(block, arrays):
    """Copy the reference's parameters ``{name: array}`` into ``block``
    (initialized, every shape known), matching names with each side's root
    prefix stripped (the reference's global prefix counters differ between
    two nets of one process).  Raises ``MXNetError`` on a missing or extra
    name or a shape that differs; values are cast to each parameter's
    dtype and device."""
    pd = block.collect_params()
    root = block.prefix
    ours = {name[len(root):]: p for name, p in pd.items()}
    keys = list(arrays)
    ref_root = _reference_root(keys, set(ours))
    theirs = {k[len(ref_root):]: arrays[k] for k in keys}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise MXNetError(f"params_from_jax: names differ (root prefixes "
                         f"{root!r} and {ref_root!r}): missing {missing}, "
                         f"extra {extra}")
    for suffix, p in ours.items():
        arr = np.asarray(theirs[suffix])
        if p._var is None:
            raise MXNetError(f"params_from_jax: {p.name} is not initialized "
                             f"(run one forward first)")
        if tuple(arr.shape) != tuple(p.shape):
            raise MXNetError(f"params_from_jax: {p.name} has shape "
                             f"{tuple(p.shape)}, the reference's "
                             f"{ref_root + suffix} {tuple(arr.shape)}")
        if arr.dtype not in (np.float16, np.float32, np.float64):
            arr = arr.astype(np.float32)   # bfloat16 and friends
        p.set_data(torch.from_numpy(np.ascontiguousarray(arr)))
