"""Symbol graph core: nodes, traversal, and evaluation over tensors.

PyTorch counterpart of ``mxnet_tpu/symbol/graph.py`` (reference: NNVM's
``Graph``/``Node``/``Symbol``).  The graph is a frontend expression DAG;
evaluating it dispatches one registered op per node in topological order
(plain Python over torch tensors, so each op launches what it launches:
cuDNN convolutions, the BatchNorm kernels for a channels-last training
BatchNorm on the card).  Gradients are torch autograd through the ops
(and the loss heads' own ``autograd.Function``s); shapes come from the
same ops run on ``meta`` tensors (``shape_solver``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ndarray.ndarray import _accepts_training
from ..ops.nn import attr_bool
from ..ops.registry import Op

__all__ = ["Node", "SymbolEntry", "OP_EXTRA_INPUTS", "attr_bool",
           "topo_order", "input_nodes", "eval_node", "release_plan",
           "trace"]

# per-op learnable and auxiliary inputs after the data inputs, for the
# variables composition creates (reference: each op's ListArguments /
# ListAuxiliaryStates); the ported ops only
OP_EXTRA_INPUTS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "FullyConnected": (("weight", "bias"), ()),
    "Convolution": (("weight", "bias"), ()),
    "Deconvolution": (("weight", "bias"), ()),
    "BatchNorm": (("gamma", "beta"), ("moving_mean", "moving_var")),
    "LayerNorm": (("gamma", "beta"), ()),
    "InstanceNorm": (("gamma", "beta"), ()),
    "Embedding": (("weight",), ()),
    "RNN": (("parameters", "state", "state_cell"), ()),
    "LeakyReLU": (("gamma",), ()),
    # the int8 serving twins: act_scale comes from the quantize node,
    # weight and wscale are the offline-quantized variables
    "_tpumx_quantized_fc_int8": (("act_scale", "weight", "wscale", "bias"),
                                 ()),
    "_tpumx_quantized_conv_int8": (("act_scale", "weight", "wscale",
                                    "bias"), ()),
}


def _active_extra_inputs(opname: str, attrs: dict
                         ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    params, aux = OP_EXTRA_INPUTS.get(opname, ((), ()))
    if opname in ("FullyConnected", "Convolution", "Deconvolution",
                  "_tpumx_quantized_fc_int8", "_tpumx_quantized_conv_int8") \
            and attr_bool(attrs.get("no_bias")):
        params = tuple(p for p in params if p != "bias")
    if opname == "LeakyReLU" and attrs.get("act_type", "leaky") != "prelu":
        params = ()
    if opname == "RNN" and attrs.get("mode", "lstm") != "lstm":
        # the op's own default mode is "lstm": only another mode drops
        # the state_cell slot
        params = ("parameters", "state")
    return params, aux


class Node:
    """One graph node: a variable or an op application."""

    __slots__ = ("kind", "name", "op", "attrs", "inputs", "attr_dict", "_uid")

    _next_uid = [0]

    def __init__(self, kind: str, name: str, op: Optional[Op] = None,
                 attrs: Optional[dict] = None,
                 inputs: Optional[List["SymbolEntry"]] = None,
                 attr_dict: Optional[dict] = None):
        self.kind = kind  # 'var' | 'op'
        self.name = name
        self.op = op
        self.attrs = attrs or {}
        self.inputs = inputs or []
        self.attr_dict = attr_dict or {}
        self._uid = Node._next_uid[0]
        Node._next_uid[0] += 1

    def num_outputs(self) -> int:
        if self.kind == "var":
            return 1
        return self.op.n_outputs(self.attrs)


class SymbolEntry:
    """(node, output_index) pair — an edge source in the DAG."""

    __slots__ = ("node", "index")

    def __init__(self, node: Node, index: int = 0):
        self.node = node
        self.index = index


def topo_order(entries: Sequence[SymbolEntry]) -> List[Node]:
    """Post-order DFS over the DAG, deduplicated; iterative, so a long
    chain does not reach Python's recursion limit (reference: nnvm
    DFSVisit)."""
    seen = set()
    order: List[Node] = []
    stack: List[tuple] = []
    for e in entries:
        if id(e.node) in seen:
            continue
        seen.add(id(e.node))
        stack.append((e.node, 0))
        while stack:
            node, i = stack[-1]
            if i < len(node.inputs):
                stack[-1] = (node, i + 1)
                child = node.inputs[i].node
                if id(child) not in seen:
                    seen.add(id(child))
                    stack.append((child, 0))
            else:
                stack.pop()
                order.append(node)
    return order


def input_nodes(entries: Sequence[SymbolEntry], include_aux=True) -> List[Node]:
    """All variable nodes in traversal order."""
    out = []
    for n in topo_order(entries):
        if n.kind == "var":
            if not include_aux and n.attr_dict.get("__is_aux__"):
                continue
            out.append(n)
    return out


def eval_node(node: Node, ins: List[torch.Tensor], is_train: bool,
              collect_aux: Optional[dict] = None, rng=None,
              device=None) -> tuple:
    """Evaluate one op node.  A training BatchNorm with ``collect_aux``
    puts its new moving mean and variance (``momentum * old + (1 -
    momentum) * batch``, detached) under its aux variables' names.  A
    random op takes ``fold_in(rng, node uid)`` (``rng`` a host key, a
    program's ``LazyKey``, or a key tensor inside a loop body, folded on
    its device; ``PRNGKey(0)`` without one), on its first input's device
    or ``device``."""
    kwargs = dict(node.attrs)
    op = node.op
    if _accepts_training(op):
        kwargs["_training"] = is_train
    if op.rng:
        from .. import random as _random

        base = rng if rng is not None else _random.prng_key(0)
        dev = ins[0].device if ins else (device or torch.device("cpu"))
        if isinstance(base, torch.Tensor):
            from ..ops.sampling import threefry2x32

            w0, w1 = threefry2x32(base[0], base[1], 0, node._uid)
            kwargs["rng_key"] = torch.stack([w0, w1]).to(dev)
        else:
            key = base.folded(node._uid) \
                if isinstance(base, _random.LazyKey) \
                else _random.fold(base, node._uid)
            kwargs["rng_key"] = _random.key_tensor(key, dev)
    if op.name == "BatchNorm" and collect_aux is not None and is_train \
            and not attr_bool(kwargs.get("use_global_stats")):
        user_wants_stats = attr_bool(node.attrs.get("output_mean_var"))
        kwargs["output_mean_var"] = True
        y, mean, var = op.fn(*ins, **kwargs)
        aux_names = [e.node.name for e in node.inputs[-2:]]
        momentum = float(kwargs.get("momentum", 0.9))
        with torch.no_grad():
            collect_aux[aux_names[0]] = \
                momentum * ins[-2] + (1 - momentum) * mean.detach()
            collect_aux[aux_names[1]] = \
                momentum * ins[-1] + (1 - momentum) * var.detach()
        return (y, mean, var) if user_wants_stats else (y,)
    out = op.fn(*ins, **kwargs)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def release_plan(entries: Sequence[SymbolEntry], order: List[Node]
                 ) -> List[List[int]]:
    """For each node of ``order``, the ids of the nodes whose values are
    needed no more once it has run (the entries' nodes are kept)."""
    last = {}
    for i, node in enumerate(order):
        for e in node.inputs:
            last[id(e.node)] = i
    for e in entries:
        last[id(e.node)] = len(order)
    plan: List[List[int]] = [[] for _ in order]
    for nid, i in last.items():
        if i < len(order):
            plan[i].append(nid)
    return plan


def trace(entries: Sequence[SymbolEntry], env: Dict[str, torch.Tensor],
          is_train: bool, collect_aux: Optional[dict] = None,
          order: Optional[List[Node]] = None,
          release: Optional[List[List[int]]] = None, rng=None,
          device=None):
    """Evaluate the DAG over ``env`` (variable name -> tensor); the
    entries' values in order.  With ``order`` and ``release``
    (``topo_order`` and ``release_plan`` of the entries, precomputed) each
    node's value is dropped after its last consumer has run.  ``rng`` (a
    host key) seeds the random nodes (:func:`eval_node`)."""
    order = order if order is not None else topo_order(entries)
    values: Dict[int, tuple] = {}
    for i, node in enumerate(order):
        if node.kind == "var":
            if node.name not in env:
                raise ValueError(f"unbound variable {node.name!r}")
            values[id(node)] = (env[node.name],)
            continue
        ins = [values[id(e.node)][e.index] for e in node.inputs]
        values[id(node)] = eval_node(node, ins, is_train, collect_aux, rng,
                                     device)
        for nid in (release[i] if release is not None else ()):
            del values[nid]
    return [values[id(e.node)][e.index] for e in entries]
