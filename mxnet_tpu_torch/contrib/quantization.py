"""INT8 quantization with calibration, the reference MXNet's contrib API
(PyTorch counterpart of ``mxnet_tpu/contrib/quantization.py``; reference:
python/mxnet/contrib/quantization.py and the QuantizeGraph pass).

:func:`quantize_model` rewrites a symbol's FullyConnected and Convolution
nodes into ``_contrib_quantize_v2 -> _contrib_quantized_* ->
_contrib_dequantize`` sandwiches (:func:`quantize_graph`), the activation
ranges fixed by calibration (naive min/max or KL entropy) when asked.
The quantized ops accumulate in exact int32 (``ops/quantization_ops.py``).
The serving route (int8 weights stored once, static scales) is
``mx.quantization``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _np

from ..base import MXNetError

__all__ = ["quantize_params", "calib_thresholds_naive",
           "calib_thresholds_entropy", "quantize_model", "quantize_graph",
           "QuantizedParam"]


class QuantizedParam:
    """An int8 tensor + scale, dequantizing to float on demand
    (reference: quantized weight layout, quantize_graph_pass.cc:97)."""

    __slots__ = ("data", "scale")

    def __init__(self, data: _np.ndarray, scale: float):
        self.data = data
        self.scale = scale

    def dequantize(self) -> _np.ndarray:
        return self.data.astype(_np.float32) * self.scale


def _quantize_symmetric(arr: _np.ndarray, threshold: Optional[float] = None):
    t = float(_np.max(_np.abs(arr))) if threshold is None else threshold
    t = max(t, 1e-8)
    scale = t / 127.0
    q = _np.clip(_np.round(arr / scale), -127, 127).astype(_np.int8)
    return QuantizedParam(q, scale)


def quantize_params(arg_params: Dict, exclude: Optional[List[str]] = None):
    """Quantize weight tensors to int8 symmetric (reference:
    quantization.py _quantize_params)."""
    exclude = set(exclude or ())
    out = {}
    for name, arr in arg_params.items():
        a = arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)
        if name in exclude or a.ndim < 2 or "bias" in name:
            out[name] = a
        else:
            out[name] = _quantize_symmetric(a)
    return out


def calib_thresholds_naive(activations: Dict[str, List[_np.ndarray]]):
    """Min/max calibration (reference: quantization.py calib_mode='naive')."""
    out = {}
    for name, batches in activations.items():
        if not batches:
            out[name] = 1e-8
            continue
        out[name] = max(max(abs(float(_np.min(x))), abs(float(_np.max(x))))
                        for x in batches)
    return out


def calib_thresholds_entropy(activations: Dict[str, List[_np.ndarray]],
                             num_bins: int = 2048,
                             num_quantized_bins: int = 255):
    """KL-divergence calibration (reference: quantization.py
    _get_optimal_thresholds / _LayerOutputMinMaxCollector)."""
    out = {}
    for name, batches in activations.items():
        samples = _np.concatenate([_np.abs(_np.ravel(b)) for b in batches])
        max_val = float(samples.max()) if samples.size else 1.0
        if max_val <= 0:
            out[name] = 1e-8
            continue
        hist, edges = _np.histogram(samples, bins=num_bins, range=(0, max_val))
        best_t, best_kl = max_val, _np.inf
        for i in range(num_quantized_bins, num_bins + 1,
                       max(1, num_bins // 64)):
            t = edges[i]
            p = hist[:i].astype(_np.float64).copy()
            p[-1] += hist[i:].sum()  # clip outliers into the last bin
            if p.sum() == 0:
                continue
            # quantize p into num_quantized_bins then expand back
            factor = i / num_quantized_bins
            q = _np.zeros(i)
            for j in range(num_quantized_bins):
                lo, hi = int(j * factor), max(int((j + 1) * factor),
                                              int(j * factor) + 1)
                chunk = p[lo:hi]
                nz = (chunk > 0).sum()
                if nz:
                    q[lo:hi] = _np.where(chunk > 0, chunk.sum() / nz, 0)
            pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
            mask = pn > 0
            kl = float(_np.sum(pn[mask] * _np.log(
                pn[mask] / _np.maximum(qn[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_t = kl, float(t)
        out[name] = best_t
    return out


_QUANTIZABLE = {"Convolution": "_contrib_quantized_conv",
                "FullyConnected": "_contrib_quantized_fully_connected"}


def quantize_graph(sym, excluded_sym_names=None, calib_thresholds=None,
                   param_shapes=None):
    """The QuantizeGraph pass (reference:
    src/operator/quantization/quantize_graph_pass.cc:97), rebuilt over this
    framework's Symbol DAG.

    Every Convolution/FullyConnected node (unless excluded) is replaced by
    a quantize_v2 → quantized-op → dequantize sandwich: activations are
    quantized to int8 at runtime (with calibrated static ranges when
    ``calib_thresholds[node_name]`` is present — no runtime min/max scan),
    weights/bias are quantized in-graph from the same float params, and the
    int32 accumulator is dequantized back to float so the surrounding graph
    is untouched.  Note the weight quantize_v2 re-runs per forward (params
    are traced jit arguments, not constants); use :func:`quantize_params`
    for offline weight quantization when that cost matters.
    """
    from ..symbol.graph import Node, SymbolEntry, topo_order
    from ..symbol.symbol import Symbol
    from ..ops.registry import get_op

    excluded = set(excluded_sym_names or ())
    calib = calib_thresholds or {}
    remap: Dict[tuple, SymbolEntry] = {}

    def mapped(e):
        return remap.get((e.node._uid, e.index), e)

    def make(opname, name, inputs, attrs):
        node = Node("op", name, get_op(opname), attrs,
                    [mapped(i) if isinstance(i, SymbolEntry) else i
                     for i in inputs])
        return [SymbolEntry(node, i)
                for i in range(node.op.n_outputs(attrs))]

    for node in topo_order(sym._entries):
        if node.kind == "var":
            # clone vars that get a known shape so the stamp never leaks
            # into the caller's original symbol (shape_solver honors the
            # clone's __shape__; every consumer below picks up the clone
            # through the remap)
            if param_shapes and node.name in param_shapes:
                clone = Node("var", node.name,
                             attr_dict=dict(node.attr_dict))
                clone.attr_dict["__shape__"] = repr(
                    tuple(param_shapes[node.name]))
                remap[(node._uid, 0)] = SymbolEntry(clone, 0)
            continue
        if node.op.name not in _QUANTIZABLE or node.name in excluded:
            if node.kind == "op":
                node_inputs = [mapped(e) for e in node.inputs]
                if any(m is not e for m, e in zip(node_inputs, node.inputs)):
                    clone = Node("op", node.name, node.op, node.attrs,
                                 node_inputs, node.attr_dict)
                    for i in range(node.num_outputs()):
                        remap[(node._uid, i)] = SymbolEntry(clone, i)
            continue
        has_bias = not node.attrs.get("no_bias") and len(node.inputs) >= 3
        data_e, weight_e = node.inputs[0], node.inputs[1]
        bias_e = node.inputs[2] if has_bias else None

        qattrs = {"out_type": "int8"}
        t = calib.get(node.name)
        if t is not None:
            qattrs["min_calib_range"] = -float(t)
            qattrs["max_calib_range"] = float(t)
        qd = make("_contrib_quantize_v2", node.name + "_quantize",
                  [data_e], qattrs)
        qw = make("_contrib_quantize_v2", node.name + "_qweight",
                  [weight_e], {"out_type": "int8"})
        ins = [qd[0], qw[0]]
        tail = [qd[1], qd[2], qw[1], qw[2]]
        if bias_e is not None:
            qb = make("_contrib_quantize_v2", node.name + "_qbias",
                      [bias_e], {"out_type": "int8"})
            ins.append(qb[0])
            tail += [qb[1], qb[2]]
        qop = make(_QUANTIZABLE[node.op.name], node.name + "_quantized",
                   ins + tail, dict(node.attrs))
        deq = make("_contrib_dequantize", node.name + "_dequantize",
                   qop, {})
        remap[(node._uid, 0)] = deq[0]

    return Symbol([mapped(e) for e in sym._entries])


def _collect_calib_thresholds(sym, arg_params, aux_params, data_names,
                              calib_data, num_calib_examples, calib_mode,
                              excluded):
    """Per-quantized-node input ranges: bind a probe symbol grouping every
    conv/fc data input, run the calibration batches, and hand the
    activations to the naive/entropy threshold pickers (reference:
    quantization.py _LayerOutputCollector path)."""
    from ..symbol.graph import topo_order
    from ..symbol.symbol import Symbol, Group
    from ..module import Module

    probes = []
    names = []
    for node in topo_order(sym._entries):
        if node.kind == "op" and node.op.name in _QUANTIZABLE \
                and node.name not in excluded:
            probes.append(Symbol([node.inputs[0]]))
            names.append(node.name)
    if not probes:
        return {}
    probe = Group(probes)
    mod = Module(probe, data_names=list(data_names), label_names=None)
    acts: Dict[str, List[_np.ndarray]] = {n: [] for n in names}
    n_seen = 0
    for batch in calib_data:
        if not mod.binded:
            mod.bind(data_shapes=calib_data.provide_data, for_training=False)
            mod.set_params(arg_params, aux_params, allow_missing=True,
                           allow_extra=True)
        mod.forward(batch, is_train=False)
        for name, out in zip(names, mod.get_outputs()):
            acts[name].append(out.asnumpy())
        n_seen += batch.data[0].shape[0]
        if num_calib_examples and n_seen >= num_calib_examples:
            break
    fn = calib_thresholds_entropy if calib_mode == "entropy" \
        else calib_thresholds_naive
    return fn(acts)


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None, ctx=None,
                   quantized_dtype="int8", logger=None):
    """Quantize a symbolic model (reference: quantization.py
    quantize_model).  Returns (quantized symbol, arg_params, aux_params):
    the symbol has conv/fc nodes rewritten to int8 compute via
    :func:`quantize_graph`; params pass through unchanged (weight
    quantization happens in-graph).  calib_mode 'naive'/'entropy' runs
    forward passes over calib_data to fix the activation ranges statically.
    """
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype!r}")
    excluded = set(excluded_sym_names or ())
    thresholds = {}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("calib_data required when calib_mode != 'none'")
        thresholds = _collect_calib_thresholds(
            sym, arg_params, aux_params, data_names, calib_data,
            num_calib_examples, calib_mode, excluded)
    shapes = {k: tuple(v.shape) for k, v in {**arg_params,
                                             **(aux_params or {})}.items()}
    qsym = quantize_graph(sym, excluded_sym_names=excluded,
                          calib_thresholds=thresholds, param_shapes=shapes)
    return qsym, arg_params, aux_params
