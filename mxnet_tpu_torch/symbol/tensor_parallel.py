"""Tensor-parallel evaluation of a symbol along partition rules.

The reference's ``compute=True`` fused step (``Executor.set_spmd``) is a
GSPMD program: XLA partitions the matmuls along the rule specs.  PyTorch
has no GSPMD, so this module partitions explicitly, Megatron style, on
the ``mp`` axis of the executor's mesh, each rank evaluating the graph on
its blocks:

- a ``FullyConnected`` whose weight is split on its output features
  (spec ``('mp', None)``, *column-parallel*) reads its input whole through
  :func:`~..parallel.collectives.pcopy` (its gradient is summed over
  ``mp``) and leaves its output split on the last (feature) axis; its bias
  is its block (spec ``('mp',)``) or, replicated, sliced to it;
- a ``FullyConnected`` whose weight is split on its input features (spec
  ``(None, 'mp')``, *row-parallel*) multiplies its input's block (cut from
  a whole input) and sums the partial products over ``mp``
  (:func:`~..parallel.collectives.psum_bcast`); the output is whole;
- elementwise ops pass a split through;
- any other node that meets a split operand gathers it whole first
  (:func:`~..parallel.collectives.allgather_bcast`), and a rule-sharded
  weight read anywhere else is gathered whole: the numbers stay the
  reference's.  :class:`TensorParallelPlan` counts those gathers by node
  (``operand_gathers``) and by weight (``weight_gathers``).

A weight used in place (column or row) is its own leaf: its gradient is
this rank's block of the whole gradient.  A gathered weight's gradient is
whole, and the executor slices it back (``gathered``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import (_gather_front, allgather_bcast, pcopy,
                                    psum_bcast)
from .graph import Node, attr_bool, eval_node, topo_order

__all__ = ["TensorParallelPlan"]

#: ops that act on each element alone: a split passes through them
ELEMENTWISE_UNARY = frozenset((
    "Activation", "relu", "sigmoid", "tanh", "softsign", "negative", "abs",
    "square", "sqrt", "exp", "log", "_mul_scalar", "_div_scalar",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_rdiv_scalar",
    "clip", "identity", "_copy", "BlockGrad", "stop_gradient"))
ELEMENTWISE_BINARY = frozenset((
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div", "_plus",
    "_minus", "_mul", "_div", "_Plus", "_Minus", "_Mul", "_Div"))


class _SliceBlock(torch.autograd.Function):
    """This rank's block of the last axis of a whole (replicated) tensor;
    the backward all-gathers the blocks' cotangents back into the whole."""

    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.args = (group, n)
        b = x.shape[-1] // n
        return x.narrow(-1, me * b, b).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        return (_gather_front(g.movedim(-1, 0), group, n).movedim(0, -1)
                .contiguous(), None, None, None)


def _spec_is(spec, want) -> bool:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec == want


class TensorParallelPlan:
    """Which rule-sharded parameters a symbol can use in place (column or
    row ``FullyConnected`` weights, column biases) and which it gathers,
    from the resolved ``specs`` (name -> spec tuple)."""

    def __init__(self, entries, specs: Dict[str, tuple]):
        self.entries = entries
        self.order = topo_order(entries)
        consumers: Dict[str, List[tuple]] = {}
        for node in self.order:
            for i, e in enumerate(node.inputs):
                if e.node.kind == "var":
                    consumers.setdefault(e.node.name, []).append((node, i))
        self.fc_mode: Dict[int, str] = {}
        local = {}
        for name, spec in specs.items():
            uses = consumers.get(name, [])
            if not uses or not all(n.op.name == "FullyConnected" and i == 1
                                   for n, i in uses):
                continue
            if _spec_is(spec, ("mp",)):
                local[name] = "col"
            elif _spec_is(spec, (None, "mp")):
                local[name] = "row"
            else:
                continue
            for n, _ in uses:
                self.fc_mode[id(n)] = local[name]
        for name, spec in specs.items():
            uses = consumers.get(name, [])
            if name not in local and uses and _spec_is(spec, ("mp",)) and \
                    all(n.op.name == "FullyConnected" and i == 2
                        and self.fc_mode.get(id(n)) == "col"
                        for n, i in uses):
                local[name] = "col_bias"
        # a row-parallel FC whose bias is sharded cannot add it whole
        for node in self.order:
            if self.fc_mode.get(id(node)) == "row" and len(node.inputs) > 2:
                b = node.inputs[2].node
                if b.kind == "var" and b.name in specs:
                    self.fc_mode.pop(id(node))
                    w = node.inputs[1].node.name
                    local.pop(w, None)
        self.local = local
        #: rule-sharded parameters gathered whole each step
        self.gathered = frozenset(n for n in specs if n not in local)
        self.operand_gathers: Dict[str, int] = {}
        self.weight_gathers: Dict[str, int] = {}

    def trace(self, env: Dict[str, torch.Tensor], mesh, is_train: bool,
              collect_aux: Optional[dict] = None, rng=None, device=None):
        """Evaluate the graph on this rank's blocks (``env`` holds the
        in-place parameters' blocks, the gathered ones whole, the rest
        whole); the entries' values come back whole."""
        group, n, me = mesh.group("mp"), mesh.shape["mp"], \
            mesh.axis_index("mp")
        for w in self.gathered:
            self.weight_gathers[w] = self.weight_gathers.get(w, 0) + 1
        values: Dict[int, tuple] = {}
        split: Dict[int, bool] = {}   # id(node) -> output split on mp

        def whole(node: Node, e) -> torch.Tensor:
            v = values[id(e.node)][e.index]
            if split.get(id(e.node)):
                self.operand_gathers[node.name] = \
                    self.operand_gathers.get(node.name, 0) + 1
                v = allgather_bcast(v, "mp", axis=v.dim() - 1, mesh=mesh)
            return v

        for node in self.order:
            if node.kind == "var":
                if node.name not in env:
                    raise ValueError(f"unbound variable {node.name!r}")
                values[id(node)] = (env[node.name],)
                continue
            mode = self.fc_mode.get(id(node))
            flat = attr_bool(node.attrs.get("flatten"), default=True)
            no_bias = attr_bool(node.attrs.get("no_bias"))
            if mode == "col":
                x = pcopy(whole(node, node.inputs[0]), "mp", mesh=mesh)
                w = values[id(node.inputs[1].node)][0]
                b = None
                if not no_bias and len(node.inputs) > 2:
                    be = node.inputs[2]
                    b = values[id(be.node)][0]
                    if self.local.get(be.node.name) != "col_bias":
                        b = _SliceBlock.apply(b, group, n, me)
                if flat and x.dim() > 2:
                    x = x.reshape(x.shape[0], -1)
                y = F.linear(x, w)
                values[id(node)] = (y if b is None else y + b,)
                split[id(node)] = True
                continue
            if mode == "row":
                xe = node.inputs[0]
                x = values[id(xe.node)][xe.index]
                if flat and x.dim() > 2:
                    x = whole(node, xe).reshape(x.shape[0], -1)
                    x = _SliceBlock.apply(x, group, n, me)
                elif not split.get(id(xe.node)):
                    x = _SliceBlock.apply(x, group, n, me)
                y = psum_bcast(F.linear(x, values[id(node.inputs[1].node)][0]),
                               "mp", mesh=mesh)
                if not no_bias and len(node.inputs) > 2:
                    y = y + values[id(node.inputs[2].node)][0]
                values[id(node)] = (y,)
                continue
            ins_split = [bool(split.get(id(e.node))) and e.node.kind == "op"
                         for e in node.inputs]
            if any(ins_split) and (
                    (node.op.name in ELEMENTWISE_UNARY
                     and len(node.inputs) == 1)
                    or (node.op.name in ELEMENTWISE_BINARY
                        and all(ins_split))):
                ins = [values[id(e.node)][e.index] for e in node.inputs]
                values[id(node)] = eval_node(node, ins, is_train,
                                             collect_aux, rng, device)
                split[id(node)] = True
                continue
            ins = [whole(node, e) for e in node.inputs]
            values[id(node)] = eval_node(node, ins, is_train, collect_aux,
                                         rng, device)
        outs = []
        for e in self.entries:
            v = values[id(e.node)][e.index]
            if split.get(id(e.node)):
                v = allgather_bcast(v, "mp", axis=v.dim() - 1, mesh=mesh)
            outs.append(v)
        return outs
