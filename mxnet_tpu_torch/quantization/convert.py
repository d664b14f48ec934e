"""Int8 graph conversion over the shared rewrite engine.

PyTorch counterpart of ``mxnet_tpu/quantization/convert.py``; the walk is
the reference's, node for node, so a converted graph's JSON is the
reference's bytes.  :func:`convert_symbol` rewrites every FullyConnected
and Convolution node into a ``quantize -> quantized-op`` pair (the
dequantize, per-channel scales and f32 bias, is the quantized op's tail,
so the rest of the graph sees float32 where it did):

- the data input goes through ``_tpumx_quantize_int8`` with the node's
  calibrated static scale when the table has one, or a dynamic absmax of
  each call's data otherwise; the engine caches the conversion per
  (producer, scale), so a tensor feeding several quantized consumers at one
  scale pays one quantize node;
- the weight variable becomes two new variables, ``{w}_int8`` (int8,
  quantized once, offline, by :func:`quantize_weights`) and ``{w}_scale``
  (f32, one per output channel);
- the op becomes its ``_tpumx_quantized_*`` twin (``ops/
  quantization_ops.py``: an exact int8 GEMM, then the scales and the
  bias).

The walk is :func:`mxnet_tpu_torch.symbol.rewrite.rewrite_graph`, the
engine AMP drives.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as _np

from ..base import MXNetError

__all__ = ["QUANTIZABLE_OPS", "convert_symbol", "quantize_weights",
           "count_quantized_nodes"]

# reference matmul/conv family -> the int8 twin op.  ``dot``/``batch_dot``
# stay float: their rhs is rarely a stored parameter, so there is no
# offline weight to quantize (the KV-cache path covers attention instead).
QUANTIZABLE_OPS: Dict[str, str] = {
    "FullyConnected": "_tpumx_quantized_fc_int8",
    "Convolution": "_tpumx_quantized_conv_int8",
}

_WQ_SUFFIX = "_int8"
_WS_SUFFIX = "_scale"


def _weight_var(entry):
    """The weight input's underlying variable (seeing through amp_cast),
    or None when the weight is computed in-graph (not quantizable)."""
    node = entry.node
    while node.kind == "op" and node.op.name == "amp_cast":
        node = node.inputs[0].node
    return node if node.kind == "var" else None


def convert_symbol(symbol, table=None,
                   exclude: Optional[Sequence[str]] = None,
                   param_shapes: Optional[Dict] = None,
                   method: Optional[str] = None):
    """Return the int8-converted symbol (the input symbol is untouched).

    ``table`` (a :class:`~mxnet_tpu_torch.quantization.CalibrationTable`)
    supplies static activation scales and weight shapes; without one,
    activations quantize dynamically in-graph and ``param_shapes`` must
    provide the weight shapes (``{name: shape}``).  Nodes in ``exclude``
    — or whose weight is not a stored variable — stay float.

    The converted graph's arguments swap each quantized ``{w}`` for
    ``{w}_int8`` + ``{w}_scale`` (:func:`quantize_weights` builds the
    matching param dict); everything else, including biases, is shared.
    """
    from ..ops.registry import get_op
    from ..symbol.graph import Node, SymbolEntry
    from ..symbol.rewrite import Replaced, rewrite_graph

    exclude = set(exclude or ())
    existing = set(symbol.list_arguments())
    quantize_op = get_op("_tpumx_quantize_int8")

    def weight_shape(name):
        if table is not None:
            sh = table.weight_shape(name)
            if sh is not None:
                return sh
        if param_shapes and name in param_shapes:
            return tuple(int(d) for d in param_shapes[name])
        return None

    def make_quantize(entry, tag, ordinal):
        # tag = ("int8", scale): the engine's conversion cache keys on it,
        # so two consumers calibrated to the SAME scale share the node
        _kind, scale = tag
        node = Node("op", f"quantize_int8_{ordinal}", op=quantize_op,
                    attrs={"scale": scale}, inputs=[entry])
        return node, tag

    def visit(node, inputs, ctx):
        opname = node.op.name
        qop = QUANTIZABLE_OPS.get(opname)
        if qop is None or node.name in exclude:
            return None
        wvar = _weight_var(node.inputs[1])
        if wvar is None:
            return None  # computed weight: no offline int8 storage
        shape = weight_shape(wvar.name)
        if shape is None:
            raise MXNetError(
                f"quantization.convert_symbol: weight shape of "
                f"{wvar.name!r} (node {node.name!r}) unknown — pass a "
                "CalibrationTable covering it or param_shapes")
        scale = table.act_scale(node.name, method) if table is not None \
            else None
        qent = ctx.convert(inputs[0], ("int8", 0.0 if scale is None
                                       else float(scale)))
        # the quantize op's second output is the (static or dynamic)
        # activation scale the quantized op dequantizes with
        sent = SymbolEntry(qent.node, 1)
        wq = Node("var", wvar.name + _WQ_SUFFIX, attr_dict={
            "__shape__": repr(tuple(shape)), "__dtype__": "int8"})
        ws = Node("var", wvar.name + _WS_SUFFIX, attr_dict={
            "__shape__": repr((int(shape[0]),))})
        q_inputs = [qent, sent, SymbolEntry(wq, 0), SymbolEntry(ws, 0)]
        no_bias = bool(node.attrs.get("no_bias")) or len(node.inputs) < 3
        if not no_bias:
            q_inputs.append(inputs[2])
        qnode = Node("op", node.name, op=get_op(qop),
                     attrs=dict(node.attrs), inputs=q_inputs,
                     attr_dict=dict(node.attr_dict))
        return Replaced([SymbolEntry(qnode, 0)], tag="f32")

    for node, _d, _w in _iter_quantizable(symbol, exclude):
        for suffix in (_WQ_SUFFIX, _WS_SUFFIX):
            wvar = _weight_var(node.inputs[1])
            if wvar is not None and wvar.name + suffix in existing:
                raise MXNetError(
                    f"quantization.convert_symbol: derived name "
                    f"{wvar.name + suffix!r} collides with an existing "
                    "argument")
    return rewrite_graph(symbol, visit, make_conversion=make_quantize,
                         default_tag="f32")


def _iter_quantizable(symbol, exclude):
    from ..symbol.graph import topo_order

    for node in topo_order(symbol._entries):
        if node.kind == "op" and node.op.name in QUANTIZABLE_OPS \
                and node.name not in exclude:
            yield node, node.inputs[0], node.inputs[1]


def quantize_weights(symbol, arg_params,
                     exclude: Optional[Sequence[str]] = None,
                     table=None) -> Dict[str, _np.ndarray]:
    """The param-dict counterpart of :func:`convert_symbol`: every
    quantized node's weight becomes ``{w}_int8`` (symmetric per-channel
    int8) + ``{w}_scale`` (f32 per-output-channel, ``absmax/127``), the
    original f32 weight is dropped, and everything else passes through.

    Scales come from ``table`` when it covers the weight (so save →
    load → convert is reproducible without the float weights) and are
    recomputed from ``arg_params`` otherwise."""
    from .calibrate import weight_channel_absmax

    exclude = set(exclude or ())
    out = {}
    quantized = {}
    for node, _d, weight_e in _iter_quantizable(symbol, exclude):
        wvar = _weight_var(weight_e)
        if wvar is None or wvar.name not in arg_params:
            continue
        if wvar.name in quantized:
            continue
        arr = arg_params[wvar.name]
        a = arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)
        a = a.astype(_np.float32)
        scales = table.weight_scales(wvar.name) if table is not None \
            else None
        if scales is None:
            scales = _np.maximum(weight_channel_absmax(a), 1e-8) / 127.0
        scales = _np.asarray(scales, _np.float32)
        if scales.shape != (a.shape[0],):
            raise MXNetError(
                f"quantize_weights: {wvar.name!r} per-channel scales have "
                f"shape {scales.shape}, expected ({a.shape[0]},) — stale "
                "calibration table?")
        bshape = (-1,) + (1,) * (a.ndim - 1)
        q = _np.clip(_np.round(a / scales.reshape(bshape)), -127,
                     127).astype(_np.int8)
        quantized[wvar.name] = (q, scales)
    for name, arr in arg_params.items():
        if name in quantized:
            q, scales = quantized[name]
            out[name + _WQ_SUFFIX] = q
            out[name + _WS_SUFFIX] = scales
        else:
            out[name] = arr
    return out


def count_quantized_nodes(symbol) -> int:
    """Number of ``_tpumx_quantized_*`` nodes (introspection/tests)."""
    from ..symbol.graph import topo_order

    qops = set(QUANTIZABLE_OPS.values())
    return sum(1 for n in topo_order(symbol._entries)
               if n.kind == "op" and n.op.name in qops)
