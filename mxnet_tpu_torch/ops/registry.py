"""Operator registry.

PyTorch counterpart of ``mxnet_tpu/ops/registry.py``.  Each op is a plain
function over ``torch.Tensor``s, ``fn(*tensors, **attrs) -> tensor |
tuple``; gradients come from torch autograd through the function body (or
the autograd Function of a kernel it calls), so an op carries no gradient
code of its own.  ``ndarray`` generates its op namespace (the ``F`` that
Gluon's ``hybrid_forward`` receives) from this table.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["Op", "register", "get_op", "list_ops", "OP_REGISTRY"]


class Op:
    """A registered operator.

    Attributes
    ----------
    name:           canonical name (the reference op's, e.g.
                    ``FullyConnected``, ``BatchNorm``).
    fn:             plain function over tensors.
    num_outputs:    static int, or a callable(attrs_dict) -> int.
    differentiable: False for ops whose outputs carry no gradient.
    rng:            op consumes a random key (none ported yet).
    """

    __slots__ = ("name", "fn", "num_outputs", "differentiable", "rng",
                 "aliases", "doc")

    def __init__(self, name, fn, num_outputs=1, differentiable=True,
                 rng=False, aliases=(), doc=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.rng = rng
        self.aliases = tuple(aliases)
        self.doc = doc or fn.__doc__

    def n_outputs(self, attrs: Dict) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def __repr__(self):
        return f"<Op {self.name}>"


OP_REGISTRY: Dict[str, Op] = {}


def register(name: Optional[str] = None, num_outputs=1, differentiable=True,
             rng=False, aliases=()):
    """Decorator registering a plain tensor function as a framework op."""

    def _reg(fn: Callable) -> Callable:
        opname = name or fn.__name__
        op = Op(opname, fn, num_outputs=num_outputs,
                differentiable=differentiable, rng=rng, aliases=aliases)
        if opname in OP_REGISTRY:
            raise ValueError(f"op {opname!r} already registered")
        for a in aliases:
            if a in OP_REGISTRY:
                raise ValueError(
                    f"op alias {a!r} already registered (would silently "
                    f"rebind it to {opname!r})")
        OP_REGISTRY[opname] = op
        for a in aliases:
            OP_REGISTRY[a] = op
        fn.op = op
        return fn

    return _reg


def get_op(name: str) -> Op:
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} not registered") from None


def list_ops():
    return sorted(set(op.name for op in OP_REGISTRY.values()))
