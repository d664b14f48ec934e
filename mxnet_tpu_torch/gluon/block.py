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

``hybridize()`` makes a block's calls run as cached programs (the
reference's CachedOp; ``gluon.cached_op``): one program per (flattened
input shapes and dtypes, ``autograd.is_training()``, argument structure),
dropped by ``hybridize()`` and ``cast()``, built again when a parameter's
storage moved (``load_parameters`` drops it too).  A call with kwargs runs
eagerly; deferred shapes resolve in an eager forward first.  Each call
draws one key from the stream and threads it into the program, where every
active child's call splits it, so a hybridized call's random masks differ
from an eager call's by design, bit for bit as the reference's do.  On a
CUDA tensor the program is captured as CUDA graphs (forward and backward)
and replayed; on a CPU tensor the same pure function runs uncaptured.
``static_alloc``/``static_shape`` are accepted and ignored.

Called with a ``Symbol`` a block builds its graph (``hybrid_forward`` with
``F = mx.sym`` and ``Parameter.var()`` for each parameter):
``HybridBlock.export`` writes it as ``-symbol.json`` with the parameters
as ``-NNNN.params`` (the reference's bytes), and :class:`SymbolBlock`
(``SymbolBlock.imports``) runs such a graph as a block.

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
from .. import random as _random
from ..base import MXNetError, dtype_name
from ..context import cpu
from ..ndarray.ndarray import NDArray
from . import cached_op
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "params_from_jax"]


def _symbol_cls():
    from ..symbol import Symbol

    return Symbol


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
        self._fwd_hooks = []
        self._fwd_pre_hooks = []

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

    def cast(self, dtype):
        """Cast every parameter (children first) to ``dtype``."""
        for child in self._children.values():
            child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each forward (reference
        semantics: the args and output as the caller passed and gets
        them; inside a captured program it runs at capture only)."""
        self._fwd_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward."""
        self._fwd_pre_hooks.append(hook)

    def apply(self, fn):
        """``fn`` on every child (recursively), then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def summary(self, *inputs):
        print(repr(self))

    def _clear_cache(self):
        pass

    def forward(self, *args):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self._hooked_call(args, kwargs, self._module_call)

    def _module_call(self, args, kwargs, grad):
        with torch.set_grad_enabled(grad):
            return torch.nn.Module.__call__(self, *args, **kwargs)

    def _hooked_call(self, args, kwargs, run):
        """The pre-hooks, ``run(args, kwargs, grad)`` on the inputs'
        tensors, the hooks.  NDArray inputs are unwrapped, ``grad`` is
        ``autograd.is_recording()`` and the outputs come back as NDArrays;
        tensor inputs keep torch's grad mode and get tensors back."""
        for hook in self._fwd_pre_hooks:
            hook(self, args)
        if not any(isinstance(a, NDArray) for a in
                   list(args) + list(kwargs.values())):
            out = run(args, kwargs, torch.is_grad_enabled())
        else:
            out = _wrap(run([_unwrap(a) for a in args],
                            {k: _unwrap(v) for k, v in kwargs.items()},
                            autograd.is_recording()))
        for hook in self._fwd_hooks:
            hook(self, args, out)
        return out

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
        parameters not yet initialized are initialized on ``ctx`` with the
        file's shape and dtype.  Cached programs are dropped."""
        loaded = _F.load(filename, ctx=cpu())
        self.apply(lambda b: b._clear_cache())
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
            if p._var is None:   # shape and dtype from the file
                p.shape = tuple(loaded[name].shape)
                p.dtype = dtype_name(loaded[name]._data.dtype)
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
        self._cached_ops = {}

    def hybridize(self, active=True, **kwargs):
        """Run this block's calls as cached programs (see the module
        doc); ``static_alloc``/``static_shape`` are accepted and
        ignored."""
        self._active = active
        self._flags = kwargs
        self._cached_ops = {}
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        super().cast(dtype)
        self._cached_ops = {}

    def _clear_cache(self):
        self._cached_ops = {}

    def _infer_param_shapes(self, args):
        """Resolve deferred parameter shapes from the input shapes
        (subclasses give ``_param_shape``)."""
        for p in self._reg_params.values():
            if p._var is None and p._deferred_init is not None:
                p._finish_deferred_init(self._param_shape(p, args))

    def _param_shape(self, param, args):
        raise DeferredInitializationError(
            f"{self.name}: cannot infer shape for {param.name}")

    def __call__(self, *args, **kwargs):
        if args and isinstance(args[0], _symbol_cls()):
            return self.forward(*args, **kwargs)
        if not self._active or kwargs:
            return super().__call__(*args, **kwargs)
        if cached_op.in_program():
            # a child inside a program: its own split of the key, as the
            # reference's nested CachedOp draws one
            old = _random.swap_key(_random.next_key())
            try:
                return super().__call__(*args)
            finally:
                _random.swap_key(old)
        return self._hooked_call(
            args, {}, lambda a, kw, grad: self._call_cached(list(a), grad))

    def _call_cached(self, args, grad_enabled):
        flat = []
        struct = cached_op.flatten(list(args), flat)
        pd = self.collect_params()
        if any(p._var is None for p in pd.values()):
            with autograd.pause():
                Block.__call__(self, *args)
        is_train = autograd.is_training()
        key = (tuple((tuple(a.shape), str(a.dtype)) for a in flat),
               is_train, repr(struct))
        prog = self._cached_ops.get(key)
        if prog is None or prog.stale():
            prog = cached_op.CachedProgram(self, struct, is_train)
            self._cached_ops[key] = prog
        need_grad = grad_enabled and (
            any(p._tensor().requires_grad for p in prog.params)
            or any(a.requires_grad for a in flat))
        return prog(flat, _random.next_key(), need_grad)

    def forward(self, x, *args, **kwargs):
        if isinstance(x, _symbol_cls()):
            from .. import symbol as _sym

            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(_sym, x, *args, **kwargs, **params)
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

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write the block's graph as ``path-symbol.json`` and its
        parameters as ``path-NNNN.params`` (``arg:``/``aux:`` full names),
        both the reference's bytes; the graph is ``hybrid_forward`` on one
        variable named ``data``, its AMP cast nodes stripped unless
        ``remove_amp_cast=False``."""
        from .. import symbol as _sym

        out = self(_sym.var("data"))
        if isinstance(out, (list, tuple)):
            out = _sym.Group(list(out))
        if remove_amp_cast:
            from ..amp import remove_amp_cast as _strip

            out = _strip(out)
        aux_names = set(out.list_auxiliary_states())
        params = {}
        for name, p in self.collect_params().items():
            kind = "aux" if p.name in aux_names else "arg"
            params[f"{kind}:{p.name}"] = p.data()
        out.save(f"{path}-symbol.json")
        _F.save(f"{path}-{epoch:04d}.params", params)


class SymbolBlock(HybridBlock):
    """A ``Symbol`` run as a block (reference: gluon/block.py
    SymbolBlock): its arguments other than the inputs are parameters named
    as in the graph, its auxiliary states ``grad_req="null"`` parameters.
    The forward evaluates the graph on the inputs' tensors with the
    executor's evaluation (``symbol.graph.trace``: one key a call, each
    random node ``fold_in(key, node uid)``); in training mode BatchNorm's
    new running statistics are written back."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as _sym

        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(outputs)
        if isinstance(inputs, _sym.Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        aux_names = outputs.list_auxiliary_states()
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self._register(name, self.params.get(
                    name, allow_deferred_init=True))
        for name in aux_names:
            self._register(name, self.params.get(
                name, allow_deferred_init=True, grad_req="null"))

    def _register(self, name, p):
        self._reg_params[name] = p
        p._bind(self, name)

    def forward(self, *args):
        from ..symbol.graph import trace

        if args and isinstance(args[0], _symbol_cls()):
            raise MXNetError("SymbolBlock: symbolic composition is not "
                             "ported (ROADMAP.md Queue 1, item 2)")
        env = dict(zip(self._input_names, args))
        for name, p in self._reg_params.items():
            env[name] = p._tensor()
        is_train = autograd.is_training()
        aux = {}
        outs = trace(self._symbol._entries, env, is_train,
                     aux if is_train else None, rng=_random.next_key(),
                     device=args[0].device if args else None)
        for name, v in aux.items():
            self._reg_params[name]._assign(v)
        return outs[0] if len(outs) == 1 else outs

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A :class:`SymbolBlock` over ``symbol_file``'s graph, with the
        parameters of ``param_file`` (as ``export`` wrote them) on
        ``ctx``."""
        from .. import symbol as _sym

        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [_sym.var(n) for n in input_names]
        ret = SymbolBlock(sym, inputs)
        if param_file is not None:
            ret.load_parameters(param_file, ctx=ctx)
        return ret


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
