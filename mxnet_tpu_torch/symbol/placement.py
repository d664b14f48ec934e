"""group2ctx placement: a symbol's nodes run on their groups' devices.

PyTorch counterpart of ``mxnet_tpu/symbol/placement.py`` (reference:
``group2ctx`` on bind, the NNVM ``PlaceDevice`` pass and
``_CrossDeviceCopy``; ``example/model-parallel``,
``docs/faq/model_parallel_lstm.md``).  Symbol-level model parallelism in
one process: the DAG is cut into contiguous same-group segments in
topological order, each segment's operands are copied onto its group's
device (``.to(device)``, the cross-device copy) and its ops run there.
Autograd carries the backward across the same boundaries (the copy's
gradient is the reverse copy), so gradients land on each argument's own
device.

A node's group comes from ``AttrScope(ctx_group=...)`` (its
``__ctx_group__`` attribute); a node without one inherits the group of its
first grouped input, else the default group (the executor's context), as
the reference's ``_assign_groups`` propagates it.  A group missing from
``group2ctx`` raises.  A variable lives on the device of the first op that
reads it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from .graph import Node, eval_node, topo_order

__all__ = ["GroupedProgram"]

_DEFAULT = "__default__"


def _assign_groups(nodes: List[Node], valid: set) -> Dict[int, str]:
    """PlaceDevice-style forward propagation: a node keeps its own
    ``__ctx_group__``; otherwise it inherits from its first grouped input;
    otherwise the default group."""
    gmap: Dict[int, str] = {}
    for node in nodes:
        if node.kind == "var":
            continue
        g = node.attr_dict.get("__ctx_group__") \
            or node.attr_dict.get("ctx_group")
        if g is not None and g not in valid:
            raise MXNetError(
                f"bind: node {node.name!r} has ctx_group {g!r} but "
                f"group2ctx only defines {sorted(valid)}")
        if g is None:
            for e in node.inputs:
                gi = gmap.get(id(e.node))
                if gi is not None:
                    g = gi
                    break
        gmap[id(node)] = g or _DEFAULT
    return gmap


def _device(c) -> torch.device:
    return c.torch_device if isinstance(c, Context) else resolve_device(c)


class GroupedProgram:
    """A symbol cut into per-group segments, each run on its device."""

    def __init__(self, symbol, group2ctx: Dict[str, object], default_ctx):
        self._entries = symbol._entries
        self._nodes = topo_order(self._entries)
        self._gmap = _assign_groups(self._nodes, set(group2ctx))
        self._devs = {name: _device(c) for name, c in group2ctx.items()}
        self._devs[_DEFAULT] = _device(default_ctx)
        # contiguous same-group segments over the op nodes
        self._segments: List[Tuple[str, List[Node]]] = []
        for node in self._nodes:
            if node.kind == "var":
                continue
            g = self._gmap[id(node)]
            if self._segments and self._segments[-1][0] == g:
                self._segments[-1][1].append(node)
            else:
                self._segments.append((g, [node]))
        # a variable's group: that of the first op reading it
        self._var_group: Dict[str, str] = {}
        for node in self._nodes:
            if node.kind != "op":
                continue
            g = self._gmap[id(node)]
            for e in node.inputs:
                if e.node.kind == "var":
                    self._var_group.setdefault(e.node.name, g)

    # -- public ---------------------------------------------------------------
    def arg_device(self, name: str) -> torch.device:
        return self._devs[self._var_group.get(name, _DEFAULT)]

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def trace(self, env: Dict[str, torch.Tensor], is_train: bool,
              collect_aux: Optional[dict] = None, rng=None):
        """``symbol.graph.trace`` with each segment on its group's device:
        the segment's operands from other devices are copied in first.
        Returns the entries' values (each on its producer's device)."""
        values: Dict[int, tuple] = {}
        for node in self._nodes:
            if node.kind == "var":
                if node.name not in env:
                    raise ValueError(f"unbound variable {node.name!r}")
                values[id(node)] = (env[node.name],)
        for g, nodes in self._segments:
            dev = self._devs[g]
            for node in nodes:
                ins = [values[id(e.node)][e.index] for e in node.inputs]
                ins = [t if t.device == dev else t.to(dev) for t in ins]
                values[id(node)] = eval_node(node, ins, is_train,
                                             collect_aux, rng, dev)
        return [values[id(e.node)][e.index] for e in self._entries]
