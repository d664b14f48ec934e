"""The ``mx.sym`` namespace: ``Symbol``, ``Variable``/``var``, ``Group``,
``load``/``load_json``, and one wrapper per op (and alias) of the port's
``OP_REGISTRY``.

PyTorch counterpart of ``mxnet_tpu/symbol/__init__.py``.  ``sym.random``,
``sym.contrib`` and the control-flow ops are not ported: their ops
(samplers, ``multinomial``, ``shuffle``, ``_contrib_*``) are not
registered in the port yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import sys

from ..ops import nn as _nn, tensor as _tensor  # noqa: F401  (registers)
from ..ops.registry import OP_REGISTRY
from . import graph  # noqa: F401
from .symbol import (Symbol, Variable, var, Group, load, load_json, zeros,
                     ones, _make_sym_wrapper)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

_mod = sys.modules[__name__]
for _name in list(OP_REGISTRY):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_wrapper(_name))
