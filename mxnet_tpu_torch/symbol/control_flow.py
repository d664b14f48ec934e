"""Control-flow symbols: ``foreach``, ``while_loop`` and ``cond``.

PyTorch counterpart of ``mxnet_tpu/symbol/control_flow.py`` (reference:
``src/operator/control_flow.cc`` ``_foreach``, ``_while_loop``,
``_cond``, and the subgraph cutting of ``python/mxnet/symbol/
contrib.py``).  The body is built as an ordinary symbol DAG under an
``__subgraph_name__`` attribute scope, cut from the outer graph
(:func:`_cut_subgraph`: an outer value the body reads becomes a closure
input of the node), and packaged as a per-call-site ``Op`` whose function
evaluates the subgraph with ``graph.trace``:

- ``_foreach`` steps over axis 0, each step's random nodes keyed by
  ``fold_in(key, t)`` (the port's threefry, on the card);
- ``_while_loop`` runs exactly ``max_iterations`` steps, each masked by
  the condition with ``torch.where`` (the loop variables frozen, the
  outputs zero after it fails), with no host read of the condition;
- ``_cond`` reads the predicate on the host and runs the taken branch,
  except inside a hybridized block's program or on ``meta`` tensors
  (shape inference), where it runs both branches and selects; there each
  branch's closure inputs pass ``torch.where(pred, x, x.detach())`` (the
  else branch's the other way round), so no gradient, NaN included,
  reaches an input through the untaken branch.

Gradients are torch autograd through the steps.  Each node carries a
``__control_flow__`` attribute with its subgraphs as symbol JSON and the
boundary names, so ``tojson`` writes the reference's bytes and
``load_json`` rebuilds the ``Op`` (:func:`op_from_spec`), nested loops
included.
"""
from __future__ import annotations

import itertools
import json as _json
from typing import Dict, List, Tuple

import torch

from .. import attribute
from ..base import MXNetError
from ..ops.registry import Op
from ..ops.sampling import threefry2x32
from .graph import Node, SymbolEntry, topo_order, trace
from .symbol import Symbol, Variable, _apply_op

__all__ = ["foreach", "while_loop", "cond", "op_from_spec"]

_uid = itertools.count()


def _as_sym_list(x) -> List[Symbol]:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _pack_like(values, template):
    """``values`` as a list iff the caller passed a list."""
    if isinstance(template, (list, tuple)):
        return list(values)
    return values[0]


def _cut_subgraph(entries: List[SymbolEntry], scope: str,
                  bound_names: set
                  ) -> Tuple[List[SymbolEntry], List[str], List[Symbol]]:
    """The DAG under ``entries`` cut at the subgraph boundary.

    Nodes with ``__subgraph_name__ == scope`` are inner; an edge from an
    outer op becomes a fresh inner variable (a closure, wired as an input
    of the control-flow node), and a free inner variable that is no loop
    variable (a layer's parameter) is a closure passed by name."""
    memo: Dict[int, Node] = {}
    cut: Dict[Tuple[int, int], SymbolEntry] = {}
    closure_names: List[str] = []
    closure_syms: List[Symbol] = []

    def rewrite(entry: SymbolEntry) -> SymbolEntry:
        n = entry.node
        if n.kind == "var":
            if n.name in bound_names:
                return entry
            if n.name not in closure_names:
                closure_names.append(n.name)
                closure_syms.append(Symbol([SymbolEntry(n)]))
            return entry
        if n.attr_dict.get("__subgraph_name__") != scope:
            key = (id(n), entry.index)
            if key not in cut:
                cname = f"{scope}_closure{len(closure_names)}"
                var_node = Node("var", cname,
                                attr_dict={"__subgraph_name__": scope})
                cut[key] = SymbolEntry(var_node)
                closure_names.append(cname)
                closure_syms.append(Symbol([entry]))
            return cut[key]
        if id(n) not in memo:
            nn = Node(n.kind, n.name, n.op, dict(n.attrs), [],
                      dict(n.attr_dict))
            memo[id(n)] = nn
            nn.inputs = [rewrite(e) for e in n.inputs]
        return SymbolEntry(memo[id(n)], entry.index)

    new_entries = [rewrite(e) for e in entries]
    return new_entries, closure_names, closure_syms


def _stamp_spec(res: Symbol, spec: dict):
    res._entries[0].node.attr_dict["__control_flow__"] = _json.dumps(spec)


def _has_rng(entries) -> bool:
    return any(n.kind == "op" and n.op.rng for n in topo_order(entries))


def _step_keys(rng_key, T: int):
    """``fold_in(rng_key, t)`` for t < T, as one (T, 2) tensor."""
    t = torch.arange(T, dtype=torch.int64, device=rng_key.device)
    w0, w1 = threefry2x32(rng_key[0], rng_key[1], torch.zeros_like(t), t)
    return torch.stack([w0, w1], dim=1)


def _device_of(arrays):
    return arrays[0].device if arrays else None


# ---------------------------------------------------------------------------
# foreach
# ---------------------------------------------------------------------------

def foreach(body, data, init_states, name: str = None):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data``; returns (the outputs stacked, the final states)."""
    scope = name or f"_foreach{next(_uid)}"
    data_list = _as_sym_list(data)
    state_list = _as_sym_list(init_states)

    item_names = [f"{scope}_item{i}" for i in range(len(data_list))]
    state_names = [f"{scope}_state{i}" for i in range(len(state_list))]
    with attribute.AttrScope(__subgraph_name__=scope):
        item_vars = [Variable(n) for n in item_names]
        state_vars = [Variable(n) for n in state_names]
        out, new_states = body(_pack_like(item_vars, data),
                               _pack_like(state_vars, init_states))
    out_list = _as_sym_list(out)
    new_state_list = _as_sym_list(new_states)
    if len(new_state_list) != len(state_list):
        raise MXNetError(
            f"foreach: body returned {len(new_state_list)} states, "
            f"expected {len(state_list)}")

    head_entries = [s._entries[0] for s in out_list + new_state_list]
    sub_entries, closure_names, closure_syms = _cut_subgraph(
        head_entries, scope, set(item_names + state_names))

    n_state, n_out = len(state_list), len(out_list)
    op = _make_foreach_op(sub_entries, item_names, state_names,
                          closure_names, n_out)
    res = _apply_op(op, data_list + state_list + closure_syms, {}, scope)
    _stamp_spec(res, {"kind": "foreach",
                      "subgraph": Symbol(sub_entries).tojson(),
                      "item_names": item_names, "state_names": state_names,
                      "closure_names": closure_names, "n_out": n_out})
    outputs = [res[i] for i in range(n_out)]
    states = [res[n_out + i] for i in range(n_state)]
    return _pack_like(outputs, out), _pack_like(states, init_states)


def _make_foreach_op(sub_entries, item_names, state_names, closure_names,
                     n_out):
    n_data, n_state = len(item_names), len(state_names)
    order = topo_order(sub_entries)
    keyed = _has_rng(sub_entries)

    def _foreach_fn(*arrays, _training=True, rng_key=None):
        datas = arrays[:n_data]
        state = list(arrays[n_data:n_data + n_state])
        cenv = dict(zip(closure_names, arrays[n_data + n_state:]))
        T = datas[0].shape[0]
        keys = _step_keys(rng_key, T) if keyed and rng_key is not None \
            else None
        ys = [[] for _ in range(n_out)]
        for t in range(T):
            env = dict(cenv)
            env.update(zip(state_names, state))
            env.update(zip(item_names, (d[t] for d in datas)))
            outs = trace(sub_entries, env, _training, order=order,
                         rng=None if keys is None else keys[t],
                         device=_device_of(arrays))
            for acc, o in zip(ys, outs[:n_out]):
                acc.append(o)
            state = outs[n_out:]
        return tuple(torch.stack(acc) for acc in ys) + tuple(state)

    return Op("_foreach", _foreach_fn, num_outputs=n_out + n_state, rng=True)


# ---------------------------------------------------------------------------
# while_loop
# ---------------------------------------------------------------------------

def while_loop(cond_fn, func, loop_vars, max_iterations, name: str = None):
    """``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond_fn(*loop_vars)`` holds, for ``max_iterations`` masked steps;
    returns (the outputs stacked, zero after the condition failed, the
    final loop variables)."""
    if max_iterations is None:
        raise MXNetError("while_loop: max_iterations is required for the "
                         "traceable path (static shapes)")
    scope = name or f"_while{next(_uid)}"
    lv_list = _as_sym_list(loop_vars)
    lv_names = [f"{scope}_lv{i}" for i in range(len(lv_list))]

    with attribute.AttrScope(__subgraph_name__=scope):
        lv_vars = [Variable(n) for n in lv_names]
        cond_out = cond_fn(*lv_vars)
        out, new_lv = func(*lv_vars)
    out_list = _as_sym_list(out)
    new_lv_list = _as_sym_list(new_lv)
    if len(new_lv_list) != len(lv_list):
        raise MXNetError(
            f"while_loop: func returned {len(new_lv_list)} loop_vars, "
            f"expected {len(lv_list)}")

    heads = [cond_out._entries[0]] + \
        [s._entries[0] for s in out_list + new_lv_list]
    sub_entries, closure_names, closure_syms = _cut_subgraph(
        heads, scope, set(lv_names))

    n_lv, n_out, T = len(lv_list), len(out_list), int(max_iterations)
    op = _make_while_op(sub_entries, lv_names, closure_names, n_out, T)
    res = _apply_op(op, lv_list + closure_syms, {}, scope)
    _stamp_spec(res, {"kind": "while_loop",
                      "subgraph": Symbol(sub_entries).tojson(),
                      "lv_names": lv_names, "closure_names": closure_names,
                      "n_out": n_out, "max_iterations": T})
    outputs = [res[i] for i in range(n_out)]
    states = [res[n_out + i] for i in range(n_lv)]
    return outputs, _pack_like(states, loop_vars)


def _make_while_op(sub_entries, lv_names, closure_names, n_out, T):
    n_lv = len(lv_names)
    order = topo_order(sub_entries)
    keyed = _has_rng(sub_entries)

    def _while_fn(*arrays, _training=True, rng_key=None):
        lv = list(arrays[:n_lv])
        cenv = dict(zip(closure_names, arrays[n_lv:]))
        keys = _step_keys(rng_key, T) if keyed and rng_key is not None \
            else None
        active = None
        ys = [[] for _ in range(n_out)]
        for t in range(T):
            env = dict(cenv)
            env.update(zip(lv_names, lv))
            outs = trace(sub_entries, env, _training, order=order,
                         rng=None if keys is None else keys[t],
                         device=_device_of(arrays))
            c = outs[0].reshape(()).to(torch.bool)
            run = c if active is None else torch.logical_and(active, c)
            for acc, o in zip(ys, outs[1:1 + n_out]):
                acc.append(torch.where(run, o, torch.zeros_like(o)))
            lv = [torch.where(run, b, a)
                  for a, b in zip(lv, outs[1 + n_out:])]
            active = run
        return tuple(torch.stack(acc) for acc in ys) + tuple(lv)

    return Op("_while_loop", _while_fn, num_outputs=n_out + n_lv, rng=True)


# ---------------------------------------------------------------------------
# cond
# ---------------------------------------------------------------------------

def cond(pred, then_func, else_func, name: str = None):
    """``then_func()`` where the scalar ``pred`` is non-zero, else
    ``else_func()``; both branches give the same shapes and dtypes."""
    scope = name or f"_cond{next(_uid)}"
    with attribute.AttrScope(__subgraph_name__=scope):
        then_out = then_func()
        else_out = else_func()
    then_list = _as_sym_list(then_out)
    else_list = _as_sym_list(else_out)
    if len(then_list) != len(else_list):
        raise MXNetError("cond: branches must return the same number of "
                         f"outputs ({len(then_list)} vs {len(else_list)})")

    n_out = len(then_list)
    then_entries, then_cnames, then_csyms = _cut_subgraph(
        [s._entries[0] for s in then_list], scope, set())
    else_entries, else_cnames, else_csyms = _cut_subgraph(
        [s._entries[0] for s in else_list], scope, set())

    op = _make_cond_op(then_entries, else_entries, then_cnames, else_cnames,
                       n_out)
    res = _apply_op(op, [pred] + then_csyms + else_csyms, {}, scope)
    _stamp_spec(res, {"kind": "cond",
                      "then_subgraph": Symbol(then_entries).tojson(),
                      "else_subgraph": Symbol(else_entries).tojson(),
                      "then_cnames": then_cnames, "else_cnames": else_cnames,
                      "n_out": n_out})
    outputs = [res[i] for i in range(n_out)] if n_out > 1 else res
    return _pack_like(_as_sym_list(outputs), then_out)


def _gate(x, keep):
    """``x`` whose gradient passes only where ``keep`` holds."""
    if not x.is_floating_point():
        return x
    return torch.where(keep, x, x.detach())


def _make_cond_op(then_entries, else_entries, then_cnames, else_cnames,
                  n_out):
    n_then = len(then_cnames)
    then_order, else_order = topo_order(then_entries), topo_order(
        else_entries)

    def _cond_fn(pred_v, *closures, _training=True, rng_key=None):
        tc, ec = closures[:n_then], closures[n_then:]
        dev = pred_v.device

        def run(entries, order, names, vals):
            return trace(entries, dict(zip(names, vals)), _training,
                         order=order, rng=rng_key, device=dev)

        from ..gluon.cached_op import in_program

        if dev.type != "meta" and not in_program():
            # one host read of the predicate; only the taken branch runs
            if bool(pred_v.reshape(-1)[0]):
                outs = run(then_entries, then_order, then_cnames, tc)
            else:
                outs = run(else_entries, else_order, else_cnames, ec)
            return tuple(outs) if n_out > 1 else outs[0]
        p = pred_v.reshape(()).to(torch.bool)
        a = run(then_entries, then_order, then_cnames,
                [_gate(c, p) for c in tc])
        b = run(else_entries, else_order, else_cnames,
                [_gate(c, ~p) for c in ec])
        picked = [torch.where(p, x, y) for x, y in zip(a, b)]
        return tuple(picked) if n_out > 1 else picked[0]

    return Op("_cond", _cond_fn, num_outputs=n_out, rng=True)


def op_from_spec(spec_json: str) -> Op:
    """The per-call-site ``Op`` of a serialized ``__control_flow__`` spec
    (``load_json``; nested control flow recurses through here)."""
    from .symbol import load_json

    spec = _json.loads(spec_json)
    kind = spec["kind"]
    if kind == "foreach":
        return _make_foreach_op(load_json(spec["subgraph"])._entries,
                                spec["item_names"], spec["state_names"],
                                spec["closure_names"], int(spec["n_out"]))
    if kind == "while_loop":
        return _make_while_op(load_json(spec["subgraph"])._entries,
                              spec["lv_names"], spec["closure_names"],
                              int(spec["n_out"]),
                              int(spec["max_iterations"]))
    if kind == "cond":
        return _make_cond_op(load_json(spec["then_subgraph"])._entries,
                             load_json(spec["else_subgraph"])._entries,
                             spec["then_cnames"], spec["else_cnames"],
                             int(spec["n_out"]))
    raise MXNetError(f"unknown control-flow kind {kind!r}")
