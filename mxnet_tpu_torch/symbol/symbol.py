"""Symbol: the symbolic expression frontend.

PyTorch counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference:
``python/mxnet/symbol/symbol.py`` — compose, infer, bind).  A Symbol is a
list of (node, index) entries over ``graph.Node``s.  ``tojson`` writes the
reference's bytes: each attribute value's ``repr`` (so attribute values
keep the Python types the caller gave: int tuples, floats, bools,
strings), ``__num_outputs__`` for multi-output nodes, ``"attrs":
{"tpu_mx": "1"}`` and ``indent=2``; ``load_json`` reads those files and
the reference MXNet's.  Binding (``simple_bind``/``bind``) makes an
:class:`~mxnet_tpu_torch.executor.Executor` on a context (the current one
by default: ``gpu(0)``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, np_dtype
from ..context import current_context
from ..ops.registry import Op, OP_REGISTRY, get_op
from .. import attribute, name as _name_mod
from .graph import Node, SymbolEntry, _active_extra_inputs, input_nodes, \
    topo_order, trace

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "zeros",
           "ones"]


class Symbol:
    __slots__ = ("_entries",)

    def __init__(self, entries: Sequence[SymbolEntry]):
        self._entries = list(entries)

    # -- identity -----------------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._entries) == 1:
            return self._entries[0].node.name
        return None

    def __repr__(self):
        outs = ", ".join(self.list_outputs())
        return f"<Symbol {outs}>"

    def __iter__(self):
        for i in range(len(self._entries)):
            yield Symbol([self._entries[i]])

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            outs = self.list_outputs()
            if index not in outs:
                raise ValueError(f"no output named {index!r}; have {outs}")
            return Symbol([self._entries[outs.index(index)]])
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    # -- listing ------------------------------------------------------------------
    def list_arguments(self) -> List[str]:
        return [n.name for n in input_nodes(self._entries)
                if not n.attr_dict.get("__is_aux__")]

    def list_outputs(self) -> List[str]:
        outs = []
        for e in self._entries:
            base = e.node.name
            if e.node.kind == "op" and e.node.num_outputs() > 1:
                outs.append(f"{base}_output{e.index}")
            elif e.node.kind == "op":
                outs.append(f"{base}_output")
            else:
                outs.append(base)
        return outs

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in input_nodes(self._entries)
                if n.attr_dict.get("__is_aux__")]

    def list_inputs(self) -> List[str]:
        return [n.name for n in input_nodes(self._entries)]

    def get_internals(self) -> "Symbol":
        entries = []
        for n in topo_order(self._entries):
            for i in range(n.num_outputs()):
                entries.append(SymbolEntry(n, i))
        return Symbol(entries)

    def get_children(self) -> Optional["Symbol"]:
        node = self._entries[0].node
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def attr(self, key):
        return self._entries[0].node.attr_dict.get(key)

    def list_attr(self):
        return dict(self._entries[0].node.attr_dict)

    def attr_dict(self):
        out = {}
        for n in topo_order(self._entries):
            if n.attr_dict:
                out[n.name] = dict(n.attr_dict)
        return out

    def _set_attr(self, **kwargs):
        for e in self._entries:
            e.node.attr_dict.update({k: str(v) for k, v in kwargs.items()})

    # -- composition --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: replace free variables with provided symbols."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        # deep-copy the reachable subgraph
        mapping: Dict[int, Node] = {}

        def copy_node(n: Node) -> Node:
            if id(n) in mapping:
                return mapping[id(n)]
            nn = Node(n.kind, n.name, n.op, dict(n.attrs),
                      [SymbolEntry(copy_node(e.node), e.index) for e in n.inputs],
                      dict(n.attr_dict))
            mapping[id(n)] = nn
            return nn

        return Symbol([SymbolEntry(copy_node(e.node), e.index) for e in self._entries])

    def _compose(self, *args, **kwargs):
        arg_names = self.list_arguments()
        repl: Dict[str, SymbolEntry] = {}
        for i, a in enumerate(args):
            repl[arg_names[i]] = a._entries[0]
        for k, v in kwargs.items():
            if k not in arg_names:
                # silent no-op on a typo'd name leaves the free variable in
                # the graph; the reference's SymbolCompose raises
                raise MXNetError(
                    f"compose: {k!r} is not an argument of this symbol "
                    f"(arguments: {arg_names})")
            repl[k] = v._entries[0]
        for n in topo_order(self._entries):
            n.inputs = [repl[e.node.name] if (e.node.kind == "var" and e.node.name in repl)
                        else e for e in n.inputs]

    # -- arithmetic ---------------------------------------------------------------
    def _binary(self, opname, other, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_op(get_op("broadcast_" + opname), [a, b], {}, None)
        scalar = float(other)
        if reverse and opname in ("sub", "div", "power", "mod"):
            return _apply_op(get_op(f"_r{opname}_scalar"), [self], {"scalar": scalar}, None)
        return _apply_op(get_op(f"_{opname}_scalar"), [self], {"scalar": scalar}, None)

    def __add__(self, other):
        return self._binary("add", other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary("sub", other)

    def __rsub__(self, other):
        return self._binary("sub", other, reverse=True)

    def __mul__(self, other):
        return self._binary("mul", other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary("div", other)

    def __rtruediv__(self, other):
        return self._binary("div", other, reverse=True)

    def __pow__(self, other):
        return self._binary("power", other)

    def __neg__(self):
        return _apply_op(get_op("negative"), [self], {}, None)

    def __eq__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary("equal", other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary("not_equal", other)
        return NotImplemented

    def __gt__(self, other):
        return self._binary("greater", other)

    def __ge__(self, other):
        return self._binary("greater_equal", other)

    def __lt__(self, other):
        return self._binary("lesser", other)

    def __le__(self, other):
        return self._binary("lesser_equal", other)

    def __hash__(self):
        return id(self)

    # method sugar shared with NDArray
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if "shape" in kw:
            shape = kw["shape"]
        return _apply_op(get_op("reshape"), [self], {"shape": tuple(shape)}, None)

    def transpose(self, axes=None):
        return _apply_op(get_op("transpose"), [self], {"axes": axes or ()}, None)

    def flatten(self):
        return _apply_op(get_op("flatten"), [self], {}, None)

    def sum(self, axis=None, keepdims=False):
        return _apply_op(get_op("sum"), [self], {"axis": axis, "keepdims": keepdims}, None)

    def mean(self, axis=None, keepdims=False):
        return _apply_op(get_op("mean"), [self], {"axis": axis, "keepdims": keepdims}, None)

    def astype(self, dtype):
        return _apply_op(get_op("cast"), [self], {"dtype": dtype_name(dtype)},
                         None)

    def slice_axis(self, axis, begin, end):
        return _apply_op(get_op("slice_axis"), [self],
                         {"axis": axis, "begin": begin, "end": end}, None)

    def expand_dims(self, axis):
        return _apply_op(get_op("expand_dims"), [self], {"axis": axis}, None)

    def softmax(self, axis=-1):
        return _apply_op(get_op("softmax"), [self], {"axis": axis}, None)

    # -- shape/type inference -----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes) like the reference.

        Output shapes come from the ops run on ``meta`` tensors; parameter
        shapes are solved forward from data shapes by per-op rules, and a
        dim given as 0 (unknown, the reference 1.x convention) is filled
        from a known weight shape where an inverse rule exists (see
        ``shape_solver``).
        """
        from .shape_solver import solve_shapes

        return solve_shapes(self, self._known_shapes(args, kwargs))

    def _known_shapes(self, args, kwargs) -> Dict[str, tuple]:
        known: Dict[str, tuple] = {}
        if args:
            for name, sh in zip(self.list_arguments(), args):
                if sh is not None:
                    known[name] = tuple(sh)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        return known

    def infer_shape_partial(self, *args, **kwargs):
        """Like infer_shape but never raises on missing information: ops
        whose inputs are unknown are skipped and the corresponding entries
        come back as None (reference: symbol.py infer_shape_partial)."""
        from .shape_solver import solve_shapes

        return solve_shapes(self, self._known_shapes(args, kwargs),
                            partial=True)

    def infer_type(self, *args, **kwargs):
        """Propagate dtypes through the graph (reference: InferType pass).

        Rules: `cast` produces its dtype attr; comparisons keep the input
        dtype; arg-index producers report float32 (reference convention);
        everything else takes its first input's dtype."""
        from .graph import topo_order as _topo

        default = _np.dtype(_np.float32)
        var_t: Dict[str, _np.dtype] = {}
        arg_names = self.list_arguments()
        for name, a in zip(arg_names, args):
            if a is not None:
                var_t[name] = np_dtype(a)
        for k, v in kwargs.items():
            var_t[k] = np_dtype(v)
        node_t: Dict[int, _np.dtype] = {}
        for n in _topo(self._entries):
            if n.kind == "var":
                var_t.setdefault(n.name, default)
                node_t[id(n)] = var_t[n.name]
                continue
            in_ts = [node_t[id(e.node)] for e in n.inputs]
            opn = n.op.name
            if opn in ("cast", "Cast", "amp_cast"):
                t = np_dtype(n.attrs.get("dtype", "float32"))
            elif opn in ("argmax", "argmin", "one_hot"):
                t = _np.dtype(_np.float32)
            else:
                t = in_ts[0] if in_ts else default
            node_t[id(n)] = t
        return ([var_t.get(nm, default) for nm in arg_names],
                [node_t[id(e.node)] for e in self._entries],
                [var_t.get(nm, default)
                 for nm in self.list_auxiliary_states()])

    # -- binding ------------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate zero arguments, gradients (``grad_req`` not ``null``)
        and aux states at the inferred shapes on ``ctx`` and bind."""
        from ..executor import Executor

        ctx = ctx or current_context()
        arg_shapes, out_shapes, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        type_dict = type_dict or {}
        from ..ndarray import zeros

        stypes = self._declared_stypes(stype_dict)
        req = grad_req if isinstance(grad_req, dict) else {n: grad_req for n in arg_names}
        from ..executor import check_csr_grad_req

        check_csr_grad_req(stypes, req)
        args = {}
        for n, sh in zip(arg_names, arg_shapes):
            args[n] = zeros(sh, ctx=ctx, dtype=type_dict.get(n, "float32"),
                            stype=stypes.get(n))
        grad_arrays = {}
        for n, sh in zip(arg_names, arg_shapes):
            if req.get(n, "null") != "null":
                grad_arrays[n] = zeros(sh, ctx=ctx, dtype=type_dict.get(n, "float32"))
        aux = {n: zeros(sh, ctx=ctx) for n, sh in zip(aux_names, aux_shapes)}
        return Executor(self, ctx, args, grad_arrays, req, aux,
                        group2ctx=group2ctx)

    def _declared_stypes(self, stype_dict=None) -> Dict[str, str]:
        """``{argument: "csr"}`` for each argument bound sparse: declared
        ``stype="csr"`` (``__storage_type__``) or given in ``stype_dict``.
        Such an argument is bound with no dense buffer (the executor feeds
        its ``data``/``indices``/``indptr``); any other storage type binds
        dense, as in the reference."""
        out = {}
        for n in input_nodes(self._entries):
            st = (stype_dict or {}).get(
                n.name, n.attr_dict.get("__storage_type__"))
            if st == "csr":
                out[n.name] = st
        return out

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor

        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        aux_names = self.list_auxiliary_states()
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        req = grad_req if isinstance(grad_req, dict) else {n: grad_req for n in arg_names}
        if isinstance(grad_req, (list, tuple)):
            req = dict(zip(arg_names, grad_req))
        return Executor(self, ctx, dict(args), dict(args_grad or {}), req,
                        dict(aux_states or {}), group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx=ctx, args=kwargs, args_grad=None, grad_req="null")
        return ex.forward(is_train=False)

    # gradient of this symbol's (summed) outputs — reference: Symbol.grad
    def grad(self, wrt: Sequence[str]) -> "Symbol":
        """Gradient symbol of the summed outputs w.r.t. ``wrt`` arguments
        (reference: Symbol.grad / nnvm Gradient pass).  The returned symbol
        has one output per name in ``wrt`` and the same arguments as self;
        binding it evaluates the gradient with ones-seeded heads, the
        seeding ``Executor.backward`` uses without ``out_grads``."""
        wrt = list(wrt)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        unknown = [w for w in wrt if w not in arg_names]
        if unknown:
            raise MXNetError(f"grad: unknown argument(s) {unknown}; "
                             f"arguments are {arg_names}")
        entries = self._entries
        in_names = arg_names + aux_names
        in_syms = []
        by_name = {n.name: n for n in input_nodes(entries)}
        for n in in_names:
            in_syms.append(Symbol([SymbolEntry(by_name[n])]))

        def _grad_fn(*arrays, _training=True):
            env = dict(zip(in_names, arrays))
            leaves = {n: env[n].detach().requires_grad_() for n in wrt}
            env.update(leaves)
            with torch.enable_grad():
                outs = trace(entries, env, _training)
                total = sum(o.float().sum() for o in outs)
                g = torch.autograd.grad(total, [leaves[n] for n in wrt],
                                        allow_unused=True)
            out = tuple(torch.zeros_like(leaves[n]) if gi is None else gi
                        for n, gi in zip(wrt, g))
            return out if len(out) > 1 else out[0]

        op = Op("_grad", _grad_fn, num_outputs=len(wrt))
        return _apply_op(op, in_syms, {},
                         (self.name or "sym") + "_grad")

    # -- serialization ------------------------------------------------------------
    def tojson(self) -> str:
        nodes = topo_order(self._entries)
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.kind == "var" else n.op.name,
                "name": n.name,
                "attrs": {k: repr(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(e.node)], e.index, 0] for e in n.inputs],
            }
            ad = dict(n.attr_dict) if n.attr_dict else {}
            if n.kind == "op" and n.num_outputs() > 1:
                # foreign bindings (cpp/src/symbol.cc) need the node's
                # output count to reproduce list_outputs naming
                ad["__num_outputs__"] = str(n.num_outputs())
            if ad:
                entry["attr_dict"] = ad
            out_nodes.append(entry)
        heads = [[nid[id(e.node)], e.index, 0] for e in self._entries]
        arg_nodes = [i for i, n in enumerate(nodes) if n.kind == "var"]
        return json.dumps({"nodes": out_nodes, "arg_nodes": arg_nodes,
                           "heads": heads, "attrs": {"tpu_mx": "1"}}, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    attrs = attribute.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") else str(init)
    if stype is not None:
        attrs["__storage_type__"] = str(stype)
    node = Node("var", name, attr_dict=attrs)
    return Symbol([SymbolEntry(node)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def _parse_attr_value(v):
    """Attr values arrive as strings both from our tojson (reprs) and from
    reference-MXNet graph JSON (bare strings like "relu", "(1, 1)", "True",
    "2.0e-05").  literal_eval covers both; anything else stays a string."""
    if not isinstance(v, str):
        return v
    import ast

    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_json(json_str: str) -> Symbol:
    """Parse graph JSON — ours or a reference ``prefix-symbol.json``
    (nnvm::Graph JSON: same nodes/arg_nodes/heads layout; reference writes
    op params under "attrs" (1.x) or "param" (pre-1.0), may carry
    "node_row_ptr" (ignored), and emits 2-element entries in old files)."""
    data = json.loads(json_str)
    nodes: List[Node] = []

    def entry_of(spec):
        nid, idx = spec[0], spec[1] if len(spec) > 1 else 0
        return SymbolEntry(nodes[nid], idx)

    for spec in data["nodes"]:
        attr_dict = spec.get("attr_dict", {})
        if spec["op"] == "null":
            n = Node("var", spec["name"], attr_dict=attr_dict)
        else:
            if "__control_flow__" in attr_dict:
                # a per-call-site op rebuilt from its embedded subgraphs
                from . import control_flow as _cf

                op = _cf.op_from_spec(attr_dict["__control_flow__"])
            elif spec["op"] not in OP_REGISTRY:
                raise MXNetError(
                    f"load_json: operator {spec['op']!r} is not ported "
                    f"(ROADMAP.md, Queue 1)")
            else:
                op = get_op(spec["op"])
            raw_attrs = spec.get("attrs", spec.get("param", {}))
            attrs = {k: _parse_attr_value(v) for k, v in raw_attrs.items()}
            inputs = [entry_of(e) for e in spec["inputs"]]
            n = Node("op", spec["name"], op, attrs, inputs, attr_dict)
        nodes.append(n)
    heads = [entry_of(e) for e in data["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def zeros(shape, dtype="float32", **kwargs):
    sh = (shape,) if isinstance(shape, int) else tuple(shape)
    c = Variable(_name_mod.current().get(None, "zeros"), shape=sh, dtype=dtype)
    c._entries[0].node.attr_dict["__const_value__"] = "0"
    return c


def ones(shape, dtype="float32", **kwargs):
    sh = (shape,) if isinstance(shape, int) else tuple(shape)
    c = Variable(_name_mod.current().get(None, "ones"), shape=sh, dtype=dtype)
    c._entries[0].node.attr_dict["__const_value__"] = "1"
    return c


# ---------------------------------------------------------------------------
# op application — autogenerated wrappers
# ---------------------------------------------------------------------------

_DECLARED_DATA_INPUTS = {
    "FullyConnected": ["data"],
    "Convolution": ["data"],
    "Deconvolution": ["data"],
    "BatchNorm": ["data"],
    "LayerNorm": ["data"],
    "InstanceNorm": ["data"],
    "Embedding": ["data"],
    "RNN": ["data"],
    "LeakyReLU": ["data"],
    "SoftmaxOutput": ["data", "label"],
    "LinearRegressionOutput": ["data", "label"],
    "MAERegressionOutput": ["data", "label"],
    "LogisticRegressionOutput": ["data", "label"],
}


def _apply_op(op: Op, inputs: List[Symbol], attrs: dict, name: Optional[str],
              attr: Optional[dict] = None) -> Symbol:
    node_name = _name_mod.current().get(name, op.name.lstrip("_"))
    entries = []
    for s in inputs:
        if len(s._entries) != 1:
            raise MXNetError(f"{op.name}: cannot take multi-output symbol as one input")
        entries.append(s._entries[0])
    # per-call attr= overrides the ambient AttrScope (reference: every op
    # wrapper accepts attr, python/mxnet/symbol/register.py generated code)
    node = Node("op", node_name, op, attrs, entries, attribute.current().get(attr))
    n_out = op.n_outputs(attrs)
    return Symbol([SymbolEntry(node, i) for i in range(n_out)])


def _make_sym_wrapper(opname):
    op = OP_REGISTRY[opname]

    def wrapper(*args, name=None, attr=None, **kwargs):
        pos_inputs: List[Symbol] = []
        sym_kwargs: Dict[str, Symbol] = {}
        for a in args:
            if isinstance(a, Symbol):
                pos_inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and isinstance(a[0], Symbol):
                pos_inputs.extend(a)
            else:
                raise TypeError(f"{opname}: positional args must be Symbols")
        for k in list(kwargs):
            if isinstance(kwargs[k], Symbol):
                sym_kwargs[k] = kwargs.pop(k)

        node_name = _name_mod.current().get(name, op.name.lstrip("_").lower())
        declared = _DECLARED_DATA_INPUTS.get(op.name)
        params, aux = _active_extra_inputs(op.name, kwargs)
        if declared is None and not params and not aux:
            # generic op: positional + any keyword symbols in given order
            inputs = pos_inputs + list(sym_kwargs.values())
            return _apply_op(op, inputs, kwargs, node_name, attr)
        # named-slot op: fill declared data slots, then params, then aux;
        # missing learnable/aux slots become auto-created variables
        # (reference: NNVM compose auto-var creation).
        order = list(declared or ["data"]) + list(params) + list(aux)
        slots: Dict[str, Symbol] = {}
        for slot, s in zip(order, pos_inputs):
            slots[slot] = s
        slots.update(sym_kwargs)
        inputs = []
        for slot in order:
            if slot in slots:
                s = slots[slot]
                if slot in aux and s._entries[0].node.kind == "var":
                    # an explicitly supplied variable feeding an aux slot IS
                    # an auxiliary state (reference: BatchNorm moving stats
                    # are aux regardless of how the var was created)
                    s._entries[0].node.attr_dict["__is_aux__"] = "1"
                inputs.append(s)
            elif slot in aux:
                v = Variable(f"{node_name}_{slot}")
                v._entries[0].node.attr_dict["__is_aux__"] = "1"
                inputs.append(v)
            else:
                # NNVM compose auto-creates variables for every missing input
                # slot — learnable params AND data slots like SoftmaxOutput's
                # label (which becomes `<name>_label`, what Module binds to)
                inputs.append(Variable(f"{node_name}_{slot}"))
        return _apply_op(op, inputs, kwargs, node_name, attr)

    wrapper.__name__ = opname
    wrapper.__doc__ = op.doc
    return wrapper
