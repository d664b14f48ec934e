"""The symbolic DAG-rewrite engine that AMP (and later int8 quantization)
drives.

PyTorch counterpart of ``mxnet_tpu/symbol/rewrite.py``; the walk is the
reference's, node for node, so a converted graph's JSON is the
reference's bytes (``tests/test_torch_amp.py`` holds both packages'
output for the reference's golden models).

- :func:`rewrite_graph` visits the DAG in topological order with a static
  *tag* per producing node (a dtype state such as ``"f32"`` or
  ``"bfloat16"``).  The ``visit`` policy sees each op node with its inputs
  already remapped into the new graph and returns ``None`` (a verbatim
  clone whose tag propagates), ``(inputs, attrs, tag)`` (a clone with
  converted inputs or amended attrs) or a :class:`Replaced` (a whole
  subgraph in the node's place).  Boundary conversions are inserted by
  :meth:`RewriteContext.convert`, cached per (producer, output, tag) so a
  value consumed twice at one tag pays one node.  Variables are shared
  with the input symbol, so names and bindings stay stable.
- :func:`strip_ops` is the inverse pass: single-input passthrough nodes
  dropped by op name (``amp.remove_amp_cast``'s engine).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

__all__ = ["PROPAGATE", "Replaced", "RewriteContext", "rewrite_graph",
           "strip_ops"]

#: out-tag sentinel: the node's tag comes from its (new) inputs' tags —
#: one distinct tag propagates, mixed tags give None (unknown)
PROPAGATE = object()


class Replaced:
    """A ``visit`` result that puts a whole subgraph in the node's place:
    ``entries[i]`` stands for the original node's output ``i``."""

    __slots__ = ("entries", "tag")

    def __init__(self, entries, tag=None):
        self.entries = list(entries)
        self.tag = tag


class RewriteContext:
    """The walk's state handed to the ``visit`` policy: the tag of each
    node, the entry remap, and the cached conversion inserter."""

    def __init__(self, make_conversion: Optional[Callable], default_tag):
        self._make = make_conversion
        self.default_tag = default_tag
        self.entry_map: Dict[tuple, object] = {}
        self._tag: Dict[int, Optional[str]] = {}
        self._cache: Dict[tuple, object] = {}
        self.counter = 0

    def tag_of(self, entry) -> Optional[str]:
        """The producing node's tag (None: unknown)."""
        return self._tag.get(id(entry.node))

    def set_tag(self, node, tag) -> None:
        self._tag[id(node)] = tag

    def convert(self, entry, tag):
        """A conversion of ``entry`` to ``tag``: inserted at the first
        request, reused after.  ``make_conversion(entry, tag, ordinal)``
        builds the node; the ordinal advances only when one is built, so
        the generated names are dense and deterministic."""
        from .graph import SymbolEntry

        key = (id(entry.node), entry.index, tag)
        ent = self._cache.get(key)
        if ent is None:
            self.counter += 1
            node, node_tag = self._make(entry, tag, self.counter)
            self.set_tag(node, node_tag)
            ent = SymbolEntry(node, 0)
            self._cache[key] = ent
        return ent


def rewrite_graph(symbol, visit: Callable, *,
                  make_conversion: Optional[Callable] = None,
                  var_tag: Optional[Callable] = None,
                  default_tag: str = "f32"):
    """``symbol`` rebuilt under a tagged-walk policy (the input symbol is
    left untouched; every op node is cloned, variables are shared).

    ``visit(node, inputs, ctx)`` decides each op node (module doc);
    ``make_conversion(entry, tag, ordinal) -> (node, node_tag)`` builds
    one conversion; ``var_tag(node)`` tags variables (default
    ``default_tag``, also the tag of a node without inputs)."""
    from .graph import Node, SymbolEntry, topo_order
    from .symbol import Symbol

    ctx = RewriteContext(make_conversion, default_tag)

    def mapped(e):
        return ctx.entry_map[(id(e.node), e.index)]

    for node in topo_order(symbol._entries):
        if node.kind == "var":
            ctx.entry_map[(id(node), 0)] = SymbolEntry(node, 0)
            ctx.set_tag(node, var_tag(node) if var_tag is not None
                        else default_tag)
            continue
        new_inputs = [mapped(e) for e in node.inputs]
        result = visit(node, new_inputs, ctx)
        if isinstance(result, Replaced):
            for i, ent in enumerate(result.entries):
                ctx.entry_map[(id(node), i)] = ent
                ctx.set_tag(ent.node, result.tag)
            continue
        if result is None:
            attrs, out_tag = dict(node.attrs), PROPAGATE
        else:
            new_inputs, attrs, out_tag = result
        if out_tag is PROPAGATE:
            in_tags = {ctx.tag_of(e) for e in new_inputs} or {default_tag}
            out_tag = in_tags.pop() if len(in_tags) == 1 else None
        new_node = Node("op", node.name, op=node.op, attrs=attrs,
                        inputs=new_inputs, attr_dict=dict(node.attr_dict))
        for i in range(new_node.num_outputs()):
            ctx.entry_map[(id(node), i)] = SymbolEntry(new_node, i)
        ctx.set_tag(new_node, out_tag)
    return Symbol([mapped(e) for e in symbol._entries])


def strip_ops(symbol, op_names: Sequence[str]):
    """Drop every single-input passthrough node whose op is in
    ``op_names``, its consumers wired to its input; only the nodes whose
    inputs changed are rebuilt.  The input symbol itself when nothing
    matched."""
    from .graph import Node, SymbolEntry, topo_order
    from .symbol import Symbol

    names = frozenset(op_names)
    entry_map: Dict[tuple, SymbolEntry] = {}

    def mapped(e):
        return entry_map.get((id(e.node), e.index), e)

    changed = False
    for node in topo_order(symbol._entries):
        if node.kind == "var":
            continue
        if node.op.name in names:
            entry_map[(id(node), 0)] = mapped(node.inputs[0])
            changed = True
            continue
        new_inputs = [mapped(e) for e in node.inputs]
        if any(a.node is not b.node or a.index != b.index
               for a, b in zip(new_inputs, node.inputs)):
            new_node = Node("op", node.name, op=node.op,
                            attrs=dict(node.attrs), inputs=new_inputs,
                            attr_dict=dict(node.attr_dict))
            for i in range(new_node.num_outputs()):
                entry_map[(id(node), i)] = SymbolEntry(new_node, i)
    if not changed:
        return symbol
    return Symbol([mapped(e) for e in symbol._entries])
