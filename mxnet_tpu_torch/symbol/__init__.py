"""The ``mx.sym`` namespace: ``Symbol``, ``Variable``/``var``, ``Group``,
``load``/``load_json``, and one wrapper per op (and alias) of the port's
``OP_REGISTRY``.

PyTorch counterpart of ``mxnet_tpu/symbol/__init__.py``.  The random
ops (``Dropout``, ``_random_*``) are graph nodes like any other, each
seeded per forward by the executor; the ``sym.random`` namespace is not
ported (ROADMAP.md, Queue 1, item 2).  ``sym.contrib`` holds every
``_contrib_*`` op under its short name and its own, and the control-flow
symbols ``foreach``, ``while_loop`` and ``cond`` (``control_flow``).
"""
from __future__ import annotations

import sys

from ..ops import (nn as _nn, random_ops as _random_ops,  # noqa: F401
                   rnn as _rnn, tensor as _tensor)   # (registers)
from ..ops.registry import OP_REGISTRY
from . import graph  # noqa: F401
from .symbol import (Symbol, Variable, var, Group, load, load_json, zeros,
                     ones, _make_sym_wrapper)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

_mod = sys.modules[__name__]
for _name in list(OP_REGISTRY):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_wrapper(_name))



class _Contrib:
    """``sym.contrib``."""


contrib = _Contrib()
for _name in list(OP_REGISTRY):
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], getattr(_mod, _name))
        setattr(contrib, _name, getattr(_mod, _name))

from .control_flow import cond, foreach, while_loop  # noqa: E402

contrib.foreach = foreach
contrib.while_loop = while_loop
contrib.cond = cond
