"""The op namespace (``nd``, and the ``F`` Gluon's ``hybrid_forward``
receives).

PyTorch counterpart of the generated op wrappers of
``mxnet_tpu/ndarray/__init__.py``: one function per registered op (and
alias), so ``F.Convolution``, ``F.BatchNorm`` and the rest resolve as in
the reference.  They take and return ``torch.Tensor``s for now; the
``NDArray`` class comes with the ``Module.fit`` slice.  An op that takes
``_training`` gets ``autograd.is_training()`` unless the caller passes it,
as the reference's ``invoke`` does.
"""
from __future__ import annotations

import inspect
import sys

from .. import autograd
from ..ops import nn as _nn, tensor as _tensor  # noqa: F401  (registers)
from ..ops.registry import OP_REGISTRY

__all__ = sorted(OP_REGISTRY)


def _make_wrapper(opname):
    op = OP_REGISTRY[opname]
    takes_training = "_training" in inspect.signature(op.fn).parameters

    def wrapper(*args, **kwargs):
        if takes_training:
            kwargs.setdefault("_training", autograd.is_training())
        return op.fn(*args, **kwargs)

    wrapper.__name__ = opname
    wrapper.__doc__ = op.doc
    return wrapper


_mod = sys.modules[__name__]
for _name in list(OP_REGISTRY):
    setattr(_mod, _name, _make_wrapper(_name))
del _mod, _name
