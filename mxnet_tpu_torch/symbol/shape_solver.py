"""Shape inference for symbol graphs.

PyTorch counterpart of ``mxnet_tpu/symbol/shape_solver.py`` (reference:
NNVM's bidirectional ``InferShape`` pass).  Output shapes come from each
op run on ``torch.device("meta")`` tensors (the reference uses
``jax.eval_shape``), so shape logic is not written twice; the shapes of
learnable and auxiliary inputs (weight, bias, gamma, ...) are solved
forward from the data shape by per-op rules, and a caller's 0 dim
(unknown, the reference 1.x convention) is filled back from a known
weight shape where an inverse rule exists.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..base import MXNetError
from ..ndarray.ndarray import _accepts_training
from ..ops.nn import is_channels_last
from ..ops.rnn import rnn_param_size
from .graph import attr_bool, _active_extra_inputs, input_nodes, topo_order

__all__ = ["solve_shapes"]

_META = torch.device("meta")

#: single-input ops that keep their input's shape and may stand between a
#: parameter variable and the op whose rule gives its shape
_PASSTHROUGH = ("amp_cast",)


def _param_shape_rule(op_name: str, slot: str, attrs: dict,
                      in_shapes: List[Tuple[int, ...]]) -> Tuple[int, ...]:
    """Shape of a learnable/aux input given the data input shapes."""
    data = in_shapes[0]
    if op_name in ("_tpumx_quantized_fc_int8", "_tpumx_quantized_conv_int8"):
        # the int8 twins: data_q has the float data's shape, the weight
        # the float op's rule, wscale and bias one entry an output
        # channel, act_scale the quantize node's (1,)
        if slot == "act_scale":
            return (1,)
        base = ("FullyConnected" if op_name == "_tpumx_quantized_fc_int8"
                else "Convolution")
        return _param_shape_rule(base, "weight" if slot == "weight"
                                 else "bias", attrs, in_shapes)
    if op_name == "FullyConnected":
        nh = int(attrs["num_hidden"])
        flat = 1
        if attr_bool(attrs.get("flatten"), default=True):
            for d in data[1:]:
                flat *= d
        else:
            flat = data[-1]
        return (nh, flat) if slot == "weight" else (nh,)
    if op_name == "Convolution":
        nf = int(attrs["num_filter"])
        kernel = tuple(int(k) for k in attrs["kernel"])
        ng = int(attrs.get("num_group", 1))
        cin = data[-1] if is_channels_last(attrs.get("layout")) else data[1]
        if slot == "weight":
            # channels-last convs take the reference's O<spatial>I weights
            if is_channels_last(attrs.get("layout")):
                return (nf,) + kernel + (cin // ng,)
            return (nf, cin // ng) + kernel
        return (nf,)
    if op_name == "Deconvolution":
        nf = int(attrs["num_filter"])
        kernel = tuple(int(k) for k in attrs["kernel"])
        ng = int(attrs.get("num_group", 1))
        if slot == "weight":
            # (in_channels, num_filter / num_group, *kernel)
            return (data[1], nf // ng) + kernel
        return (nf,)
    if op_name in ("BatchNorm", "InstanceNorm"):
        ax = int(attrs.get("axis", 1))
        return (data[ax],)
    if op_name == "LayerNorm":
        return (data[int(attrs.get("axis", -1))],)
    if op_name == "Embedding":
        return (int(attrs["input_dim"]), int(attrs["output_dim"]))
    if op_name == "LeakyReLU":
        return (data[1],)
    if op_name == "RNN":
        H = int(attrs["state_size"])
        L = int(attrs["num_layers"])
        bi = bool(attrs.get("bidirectional", False))
        T, N, I = data
        if slot == "parameters":
            return (rnn_param_size(attrs.get("mode", "lstm"), L, I, H, bi),)
        return (L * (2 if bi else 1), N, H)
    raise MXNetError(f"no shape rule for {op_name}.{slot}")


def _label_shape(op_name: str, attrs: dict,
                 data: Tuple[int, ...]) -> Tuple[int, ...]:
    """Label shape of a loss head from its data shape (the reference infers
    it backward from data, so binding without label shapes works)."""
    if op_name in ("SoftmaxOutput", "Softmax"):
        if attr_bool(attrs.get("multi_output")):
            return (data[0],) + tuple(data[2:])
        if attr_bool(attrs.get("preserve_shape")):
            return tuple(data[:-1])
        return (data[0],)
    if op_name == "SVMOutput":
        return (data[0],)
    # regression heads: label congruent with data
    return tuple(data)


_LABEL_OPS = ("SoftmaxOutput", "Softmax", "SVMOutput",
              "LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput")


def _invert_data_shape(op_name: str, attrs: dict, partial: Tuple[int, ...],
                       param_shapes: Dict[str, Tuple[int, ...]]):
    """Fill 0 (unknown) dims of a data input from known parameter shapes:
    a known weight pins the data's feature/channel dimension."""
    out = list(partial)
    w = param_shapes.get("weight")
    if w is None or len(w) < 2:
        return tuple(out)
    if op_name == "FullyConnected":
        if attr_bool(attrs.get("flatten"), default=True):
            if len(out) == 2 and out[1] == 0:
                out[1] = w[1]
        elif out and out[-1] == 0:
            out[-1] = w[1]
    elif op_name == "Convolution":
        ng = int(attrs.get("num_group", 1))
        if is_channels_last(attrs.get("layout")):
            if out and out[-1] == 0:
                out[-1] = w[-1] * ng
        elif len(out) > 1 and out[1] == 0:
            out[1] = w[1] * ng
    return tuple(out)


def _meta_out_shapes(op, attrs: dict, in_shapes) -> tuple:
    kwargs = dict(attrs)
    if _accepts_training(op):
        kwargs["_training"] = False
    ins = [torch.empty(s, dtype=torch.float32, device=_META)
           for s in in_shapes]
    with torch.no_grad():
        out = op.fn(*ins, **kwargs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(tuple(o.shape) for o in outs)


def solve_shapes(symbol, known: Dict[str, Tuple[int, ...]],
                 partial: bool = False):
    """Returns (arg_shapes, out_shapes, aux_shapes) in listing order.

    A dim of 0 in a caller-supplied shape means UNKNOWN and is filled from
    known parameter shapes where an inverse rule exists.  With
    ``partial=True`` unknown inputs skip their consuming ops instead of
    raising, and unresolved entries come back as None (reference:
    infer_shape_partial)."""
    entries = symbol._entries
    shapes: Dict[int, Tuple] = {}  # id(node) -> tuple of output shapes
    var_shape: Dict[str, Tuple[int, ...]] = dict(known)

    def _complete(sh) -> bool:
        return sh is not None and all(d > 0 for d in sh)

    def _source(e):
        """``e`` followed up through passthrough casts (AMP's
        ``amp_cast``): the entry whose shape it carries, and the casts."""
        chain = []
        while e.node.kind == "op" and e.node.op.name in _PASSTHROUGH \
                and id(e.node) not in shapes:
            chain.append(e.node)
            e = e.node.inputs[0]
        return e, chain

    for node in topo_order(entries):
        if node.kind == "var":
            if _complete(var_shape.get(node.name)):
                shapes[id(node)] = (tuple(var_shape[node.name]),)
            elif node.attr_dict.get("__shape__"):
                sh = tuple(eval(node.attr_dict["__shape__"]))  # noqa: S307 — own format
                if node.name not in var_shape:
                    var_shape[node.name] = sh
                # a declared shape with 0-dims stays deferred so backward
                # inference can fill it, same as caller-supplied partials
                if _complete(var_shape[node.name]):
                    shapes[id(node)] = (tuple(var_shape[node.name]),)
            # else: deferred — a consuming op's rule fills it
            continue
        op = node.op
        if op.name in _PASSTHROUGH and id(node.inputs[0].node) not in shapes:
            # a cast of a parameter whose shape its consumer's rule gives:
            # filled in (backward) when that consumer is solved
            continue
        params, aux = _active_extra_inputs(op.name, node.attrs)
        extra = list(params) + list(aux)
        n_data = len(node.inputs) - len(extra)
        in_shapes: List[Tuple[int, ...]] = []
        unknown_input = False
        # data inputs must be known — except a loss head's label variable
        # (inferred from the data shape) and a var with 0-dims a known
        # weight can pin (backward inference)
        for i, e in enumerate(node.inputs[:n_data]):
            if id(e.node) not in shapes:
                if (i == n_data - 1 and op.name in _LABEL_OPS
                        and e.node.kind == "var" and in_shapes):
                    sh = _label_shape(op.name, node.attrs, in_shapes[0])
                    var_shape[e.node.name] = sh
                    shapes[id(e.node)] = (sh,)
                    in_shapes.append(sh)
                    continue
                if e.node.kind == "var" and e.node.name in var_shape:
                    pshapes = {
                        slot: var_shape[p.node.name]
                        for slot, p in zip(extra, node.inputs[n_data:])
                        if p.node.kind == "var"
                        and _complete(var_shape.get(p.node.name))}
                    cand = _invert_data_shape(op.name, node.attrs,
                                              var_shape[e.node.name], pshapes)
                    if _complete(cand):
                        var_shape[e.node.name] = cand
                        shapes[id(e.node)] = (cand,)
                        in_shapes.append(cand)
                        continue
                if partial:
                    unknown_input = True
                    break
                raise MXNetError(
                    f"infer_shape: input {e.node.name!r} of op {node.name!r} has unknown shape")
            in_shapes.append(shapes[id(e.node)][e.index])
        if unknown_input:
            continue  # partial mode: this op's outputs stay unknown
        # solve param/aux shapes; caller-given shapes are validated against
        # the op's rule — a wrong weight shape raises
        for slot, e in zip(extra, node.inputs[n_data:]):
            e, casts = _source(e)
            given = var_shape.get(e.node.name) \
                if e.node.kind == "var" else None
            if id(e.node) in shapes and given is None:
                in_shapes.append(shapes[id(e.node)][e.index])
                continue
            try:
                sh = _param_shape_rule(op.name, slot, node.attrs, in_shapes)
            except MXNetError:
                if id(e.node) in shapes:  # no rule, but shape known: accept
                    in_shapes.append(shapes[id(e.node)][e.index])
                    continue
                raise
            if given is not None and (
                    len(given) != len(sh)
                    or any(g not in (0, s) for g, s in zip(given, sh))):
                raise MXNetError(
                    f"infer_shape: {e.node.name!r} given as {tuple(given)} "
                    f"but op {node.name!r} requires {sh}")
            var_shape[e.node.name] = sh
            shapes[id(e.node)] = (sh,)
            for c in casts:
                shapes[id(c)] = (sh,)
            in_shapes.append(sh)
        try:
            shapes[id(node)] = _meta_out_shapes(op, node.attrs, in_shapes)
        except Exception as e:
            raise MXNetError(f"infer_shape failed at op {node.name!r} ({op.name}): {e}") from e

    def listed(aux: bool):
        out = []
        for n in input_nodes(entries):
            if bool(n.attr_dict.get("__is_aux__")) != aux:
                continue
            if not _complete(var_shape.get(n.name)):
                if partial:
                    out.append(None)
                    continue
                raise MXNetError(
                    f"infer_shape: could not determine shape of {n.name!r}")
            out.append(tuple(var_shape[n.name]))
        return out

    arg_shapes, aux_shapes = listed(False), listed(True)
    out_shapes = []
    for e in entries:
        if id(e.node) in shapes:
            out_shapes.append(shapes[id(e.node)][e.index])
        elif partial:
            out_shapes.append(None)
        else:
            raise MXNetError(
                f"infer_shape: could not determine shape of output "
                f"{e.node.name!r}")
    return arg_shapes, out_shapes, aux_shapes
