"""Recording and training scopes, and the autograd tape API over torch
autograd.

PyTorch counterpart of ``mxnet_tpu/autograd.py``: ``record``/``pause``/
``train_mode``/``predict_mode``, ``is_recording``/``is_training``,
``mark_variables``, ``backward``, ``grad`` and ``Function``.

The scopes set per-thread flags.  Layers read the training flag
(BatchNorm trains on batch statistics only under ``is_training()``).  The
recording flag decides whether a graph is built, at the NDArray boundary
only: an NDArray op, and a block called with NDArrays, run with torch's
grad mode set from it, so nothing is recorded outside ``record()``, as in
the reference.  Raw-tensor callers (``block_train_fn``, ``train_step``,
``DataParallelTrainer``) keep torch's own grad mode: the scopes leave it
alone for them.

The tape is torch's graph.  :func:`mark_variables` (and
``NDArray.attach_grad``, and every Gluon ``Parameter`` whose ``grad_req``
is not ``"null"``) makes an array's tensor a leaf that requires grad and
records it, per thread, with its gradient buffer and ``grad_req``.
:func:`backward` takes ``torch.autograd.grad`` of the heads over every live
marked variable and **writes** (``"write"``) or **adds** (``"add"``) each
gradient into its buffer; a variable the heads do not reach gets zero.
Torch's own ``.grad`` accumulation is never used.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function"]

_tls = threading.local()


def _st():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
        _tls.marked = {}   # id(var) -> (weakref(var), weakref(grad), req)
    return _tls


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec = recording
        self._train = training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode: bool = True) -> _Scope:
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(recording=False, training=train_mode)


def train_mode() -> _Scope:
    return _Scope(training=True)


def predict_mode() -> _Scope:
    return _Scope(training=False)


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def check_inplace(arr) -> None:
    """Raise if an in-place write to ``arr`` under ``record()`` would
    change a marked variable (reference: in-place writes to recorded
    arrays are refused)."""
    st = _st()
    if not st.recording:
        return
    entry = st.marked.get(id(arr))
    if entry is not None and entry[0]() is arr:
        raise MXNetError(
            "in-place write to a marked variable inside autograd.record(); "
            "gradients would be computed from the overwritten value. Use "
            "out-of-place ops inside autograd.record()")


# ---------------------------------------------------------------------------
# variables, backward and grad
# ---------------------------------------------------------------------------

def _make_leaf(v) -> None:
    t = v._data
    if not t.is_floating_point():
        raise MXNetError(f"cannot take gradients of a {t.dtype} array")
    if t.grad_fn is not None:
        v._data = t.detach()
        t = v._data
    if not t.requires_grad:
        t.requires_grad_(True)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers ``gradients`` to ``variables`` (reference:
    MXAutogradMarkVariables): each variable's tensor becomes a leaf that
    requires grad, and :func:`backward` fills its buffer by its
    ``grad_req`` (``"write"``, ``"add"`` or ``"null"``)."""
    st = _st()
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}")
        v._grad = g
        v._grad_req = req
        if req != "null":
            _make_leaf(v)
        st.marked[id(v)] = (weakref.ref(v), weakref.ref(g), req)


def _live_variables():
    st = _st()
    out = []
    for key, (vref, gref, req) in list(st.marked.items()):
        v, g = vref(), gref()
        if v is None or g is None:
            del st.marked[key]
            continue
        if req != "null" and v._data.requires_grad:
            out.append((v, g, req))
    return out


def _heads_and_cotangents(heads, head_grads):
    """The heads that carry a graph, with their cotangents (ones where
    ``head_grads`` gives none)."""
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    hs, cts = [], []
    for i, h in enumerate(heads):
        if not h._data.requires_grad:
            continue   # off the graph: contributes zero
        hg = None if head_grads is None else head_grads[i]
        hs.append(h._data)
        cts.append(torch.ones_like(h._data) if hg is None else
                   (hg._data if hasattr(hg, "_data") else
                    torch.as_tensor(hg, dtype=h._data.dtype,
                                    device=h._data.device)))
    return hs, cts


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (vector heads take cotangents of ones unless
    ``head_grads`` gives them) with respect to every live marked variable,
    written into or added to the variables' gradient buffers by their
    ``grad_req`` (reference: Imperative::Backward)."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    entries = _live_variables()
    if not entries:
        raise MXNetError("no variables marked for gradient (call "
                         "attach_grad first)")
    hs, cts = _heads_and_cotangents(heads, head_grads)
    if hs:
        grads = torch.autograd.grad(hs, [v._data for v, _, _ in entries],
                                    cts, retain_graph=retain_graph,
                                    allow_unused=True)
    else:
        grads = [None] * len(entries)
    write, write_src, add, add_src, zero = [], [], [], [], []
    for (v, g, req), r in zip(entries, grads):
        if r is None:
            if req == "write":
                zero.append(g._data)
        elif req == "write":
            write.append(g._data)
            write_src.append(r)
        else:
            add.append(g._data)
            add_src.append(r)
    with torch.no_grad():
        if write:
            torch._foreach_copy_(write, write_src)
        if add:
            torch._foreach_add_(add, add_src)
        if zero:
            torch._foreach_zero_(zero)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as new
    NDArrays (reference: autograd.grad); ``create_graph=True`` records the
    gradient computation, so a further backward differentiates it."""
    from .ndarray.ndarray import NDArray

    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    variables = list(variables) if isinstance(variables, (list, tuple)) \
        else [variables]
    hs, cts = _heads_and_cotangents(heads, head_grads)
    leaves = [v._data for v in variables]
    if retain_graph is None:
        retain_graph = create_graph
    if hs:
        with torch.enable_grad():
            res = torch.autograd.grad(hs, leaves, cts,
                                      retain_graph=retain_graph,
                                      create_graph=create_graph,
                                      allow_unused=True)
    else:
        res = [None] * len(leaves)
    return [NDArray(torch.zeros_like(t.detach()) if r is None else r)
            for t, r in zip(leaves, res)]


# ---------------------------------------------------------------------------
# custom Function (reference: python/mxnet/autograd.py Function)
# ---------------------------------------------------------------------------

class _TorchFunction(torch.autograd.Function):
    """Runs a :class:`Function`'s NDArray ``forward`` and ``backward``
    (both outside recording) as one torch autograd node."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray

        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        func._multi = isinstance(outs, (tuple, list))
        ctx.func = func
        outs = list(outs) if func._multi else [outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        from .ndarray.ndarray import NDArray

        with pause():
            grads = ctx.func.backward(*[NDArray(g) for g in gs])
        grads = grads if isinstance(grads, (tuple, list)) else (grads,)
        return (None,) + tuple(None if g is None else g._data for g in grads)


class Function:
    """A user-defined differentiable function: subclass, implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` over
    NDArrays, and keep state on ``self`` (``save_for_backward``).  Under
    ``record()`` the call is one torch autograd node whose backward calls
    yours."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _TorchFunction.apply(self, *[i._data for i in inputs])
        outs = [NDArray(o) for o in outs]
        return tuple(outs) if self._multi else outs[0]
