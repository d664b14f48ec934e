"""``mx.nd.contrib``: the ``_contrib_*`` ops under their short names (and
their own), and the imperative control flow ``foreach``, ``while_loop``
and ``cond``.

PyTorch counterpart of ``mxnet_tpu/ndarray/contrib.py``.  Each function
takes NDArrays (the imperative path) or tensors (a block's
``hybrid_forward``, which gets tensors), and gives back the same kind.
It has the reference's two routes; the port's
``gluon.cached_op.in_program()`` plays the part of the reference's
``_is_traced``:

- eagerly, a Python loop whose ops autograd records, the condition read
  on the host;
- inside a hybridized block's program (captured as a CUDA graph on the
  card), nothing reads the card: ``foreach`` unrolls over the leading
  axis, ``while_loop`` runs exactly ``max_iterations`` steps (then
  required), each masked by the condition with ``torch.where`` and its
  outputs zero after the condition fails, and ``cond`` runs both branches
  and selects.  The reference traces a loop body once (``lax.scan``), so
  a random op there draws the same key at every step: the unrolled loop
  replays the stream from the same key at each step, and leaves it as one
  step left it.
"""
from __future__ import annotations

import sys

import torch

from ..ops.registry import OP_REGISTRY
from .ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]

_mod = sys.modules[__name__]


def _install():
    nd = sys.modules[__name__.rsplit(".", 1)[0]]   # the generated wrappers
    for name in list(OP_REGISTRY):
        if name.startswith("_contrib_") and hasattr(nd, name):
            setattr(_mod, name[len("_contrib_"):], getattr(nd, name))
            setattr(_mod, name, getattr(nd, name))


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _pack_like(values, template):
    if isinstance(template, (list, tuple)):
        return list(values)
    return values[0]


def _in_program() -> bool:
    from ..gluon.cached_op import in_program

    return in_program()


def _raw(x):
    return x._data if isinstance(x, NDArray) else x


def _wrap_like(t, like):
    return NDArray(t) if isinstance(like, NDArray) else t


def _stack(items):
    if isinstance(items[0], NDArray):
        from . import stack

        return stack(*items, axis=0)
    return torch.stack(items, dim=0)


class _SameKeyEachStep:
    """Inside a program: every step starts from the stream's key at the
    loop's start; the loop leaves the stream as its first step did."""

    def __init__(self):
        from .. import random as _random

        self._random = _random
        self._start = _random._get_key()
        self._after = None

    def step(self, t):
        if t:
            self._random.swap_key(self._start)

    def stepped(self, t):
        if t == 0:
            self._after = self._random._get_key()

    def close(self):
        if self._after is not None:
            self._random.swap_key(self._after)


def foreach(body, data, init_states):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data``; returns the outputs stacked and the final states
    (reference: ``_foreach``)."""
    seq = _as_list(data)
    st = _pack_like(_as_list(init_states), init_states)
    T = seq[0].shape[0]
    keys = _SameKeyEachStep() if _in_program() else None
    outs, out_is_list = None, False
    for t in range(T):
        if keys is not None:
            keys.step(t)
        xs = [s[t] for s in seq]
        out, st = body(xs[0] if len(xs) == 1 else xs, st)
        if keys is not None:
            keys.stepped(t)
        out_is_list = isinstance(out, (list, tuple))
        out_list = list(out) if out_is_list else [out]
        if outs is None:
            outs = [[] for _ in out_list]
        for acc, o in zip(outs, out_list):
            acc.append(o)
    if keys is not None:
        keys.close()
    if outs is None:   # a zero-length sequence
        return [], st
    stacked = [_stack(acc) for acc in outs]
    return (stacked if out_is_list else stacked[0]), st


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times; returns
    the outputs stacked (inside a program: ``max_iterations`` rows, zero
    after the condition failed) and the final loop variables (reference:
    ``_while_loop``)."""
    lv = list(loop_vars)
    if _in_program():
        return _masked_while_loop(cond, func, lv, max_iterations)
    steps, outs = 0, None
    while bool(_raw(cond(*lv)).reshape(-1)[0]) and \
            (max_iterations is None or steps < max_iterations):
        out, lv = func(*lv)
        out_list = out if isinstance(out, list) else [out]
        if outs is None:
            outs = [[] for _ in out_list]
        for acc, o in zip(outs, out_list):
            acc.append(o)
        steps += 1
    if outs is None:
        return [], lv
    return [_stack(acc) for acc in outs], lv


def _masked_while_loop(cond, func, lv, max_iterations):
    if max_iterations is None:
        raise ValueError("while_loop inside a hybridized block requires "
                         "max_iterations (a fixed trip count)")
    keys = _SameKeyEachStep()
    active, ys = None, None
    for t in range(int(max_iterations)):
        keys.step(t)
        c = _raw(cond(*lv)).reshape(()).to(torch.bool)
        run = c if active is None else torch.logical_and(active, c)
        out, new_lv = func(*lv)
        keys.stepped(t)
        lv = [_wrap_like(torch.where(run, _raw(n), _raw(a)), a)
              for a, n in zip(lv, new_lv)]
        step = [_wrap_like(torch.where(run, _raw(o),
                                       torch.zeros_like(_raw(o))), o)
                for o in _as_list(out)]
        if ys is None:
            ys = [[] for _ in step]
        for acc, o in zip(ys, step):
            acc.append(o)
        active = run
    keys.close()
    return [_stack(acc) for acc in (ys or [])], lv


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` (a one-element array) is non-zero,
    else ``else_func()``; inside a program both run and the outputs are
    selected (both branches must match in shape and dtype) (reference:
    ``_cond``)."""
    if not _in_program():
        if bool(_raw(pred).reshape(-1)[0]):
            return then_func()
        return else_func()
    p = _raw(pred).reshape(()).to(torch.bool)
    a, b = then_func(), else_func()
    picked = [_wrap_like(torch.where(p, _raw(x), _raw(y)), x)
              for x, y in zip(_as_list(a), _as_list(b))]
    return picked if isinstance(a, (list, tuple)) else picked[0]


_install()
