"""Post-training calibration: activation statistics and per-channel
weight absmax, kept as a :class:`CalibrationTable`.

PyTorch counterpart of ``mxnet_tpu/quantization/calibrate.py``.  The pass
binds a probe ``Group`` of every quantizable node's data input through
``Module`` (on the current context: the card under ``mx.gpu()``), runs the
calibration batches, copies each probed activation to the host and
collects, per node:

- the per-tensor ``min``, ``max`` and ``absmax`` (the naive threshold);
- a ``percentile`` threshold of ``|x|`` (outlier clipping);
- optionally the KL/entropy threshold of ``contrib.quantization``;

and for every quantizable node's weight its per-output-channel absmax and
its full shape (so a table alone is enough to convert a graph).

The table is JSON with the payload's sha256 embedded: a truncated, edited
or bit-flipped file raises :class:`MXNetError` naming the file.  The file
is the reference's format, so a table saved by either package loads in
the other and gives the same scales.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as _np

from ..base import MXNetError

__all__ = ["CalibrationTable", "calibrate", "calibrate_module",
           "weight_channel_absmax"]

_FORMAT = 1
# |x| samples kept per activation for percentile/entropy estimation —
# capped per batch so calibration memory is bounded by the iterator length
_SAMPLE_CAP = 1 << 16


def weight_channel_absmax(arr: _np.ndarray) -> _np.ndarray:
    """Per-output-channel absmax of a weight tensor — channel axis 0 for
    both FC ``(out, in)`` and Conv ``(O, ...)`` reference layouts."""
    a = _np.abs(_np.asarray(arr, _np.float32))
    return a.reshape(a.shape[0], -1).max(axis=1)


class CalibrationTable:
    """Serializable calibration result.

    ``activations``: ``{node_name: {"min", "max", "absmax", "percentile",
    "entropy"?, "samples"}}`` keyed by the quantizable node's name.
    ``weights``: ``{param_name: {"absmax": [per-channel], "shape": [...]}}``.
    ``method`` picks which activation statistic :meth:`threshold` resolves
    by default (``"naive"`` absmax / ``"percentile"`` / ``"entropy"``).
    """

    def __init__(self, activations: Optional[Dict] = None,
                 weights: Optional[Dict] = None, method: str = "naive"):
        if method not in ("naive", "percentile", "entropy"):
            raise MXNetError(
                f"CalibrationTable: unknown method {method!r} "
                "(naive/percentile/entropy)")
        self.activations = dict(activations or {})
        self.weights = dict(weights or {})
        self.method = method

    # -- scale resolution ---------------------------------------------------------
    def threshold(self, node_name: str,
                  method: Optional[str] = None) -> Optional[float]:
        """The symmetric clip threshold for a node's data input, or None
        when the node was never calibrated (conversion then falls back to
        dynamic in-graph scales)."""
        ent = self.activations.get(node_name)
        if ent is None:
            return None
        m = method or self.method
        if m == "entropy" and ent.get("entropy") is None:
            m = "naive"  # entropy not collected for this node
        key = {"naive": "absmax", "percentile": "percentile",
               "entropy": "entropy"}[m]
        return max(float(ent[key]), 1e-8)

    def act_scale(self, node_name: str,
                  method: Optional[str] = None) -> Optional[float]:
        t = self.threshold(node_name, method)
        return None if t is None else t / 127.0

    def weight_scales(self, param_name: str) -> Optional[_np.ndarray]:
        ent = self.weights.get(param_name)
        if ent is None:
            return None
        return _np.maximum(_np.asarray(ent["absmax"], _np.float32),
                           1e-8) / 127.0

    def weight_shape(self, param_name: str):
        ent = self.weights.get(param_name)
        return None if ent is None else tuple(int(d) for d in ent["shape"])

    # -- serialization (checksummed, as the checkpoint manifests) ----------------
    def _payload(self) -> dict:
        return {"format": _FORMAT, "method": self.method,
                "activations": self.activations, "weights": self.weights}

    @staticmethod
    def _digest(payload: dict) -> str:
        canon = json.dumps(payload, sort_keys=True,
                           separators=(",", ":")).encode()
        return hashlib.sha256(canon).hexdigest()

    def save(self, path: str) -> str:
        """Atomic write (tmp + rename) with the payload sha256 embedded."""
        payload = self._payload()
        doc = dict(payload, sha256=self._digest(payload))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        """Validated load: a missing, truncated, corrupt, or
        checksum-mismatched file raises MXNetError naming ``path``."""
        if not os.path.exists(path):
            raise MXNetError(f"calibration table {path!r} does not exist")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (ValueError, OSError) as e:
            raise MXNetError(
                f"calibration table {path!r} is corrupt or truncated: "
                f"{e}") from e
        if not isinstance(doc, dict) or "sha256" not in doc:
            raise MXNetError(
                f"calibration table {path!r} is missing its integrity "
                "checksum (not a CalibrationTable file?)")
        claimed = doc.pop("sha256")
        if cls._digest(doc) != claimed:
            raise MXNetError(
                f"calibration table {path!r} failed checksum validation "
                "(bit flip or hand edit) — refusing to convert with "
                "untrusted scales")
        if doc.get("format") != _FORMAT:
            raise MXNetError(
                f"calibration table {path!r} has unsupported format "
                f"{doc.get('format')!r} (expected {_FORMAT})")
        return cls(activations=doc.get("activations"),
                   weights=doc.get("weights"),
                   method=doc.get("method", "naive"))

    def __repr__(self):
        return (f"CalibrationTable(method={self.method!r}, "
                f"activations={len(self.activations)}, "
                f"weights={len(self.weights)})")


def _quantizable_nodes(sym, exclude):
    """[(node, data_entry, weight_entry)] for the matmul/conv/FC family."""
    from ..symbol.graph import topo_order
    from .convert import QUANTIZABLE_OPS

    out = []
    for node in topo_order(sym._entries):
        if node.kind != "op" or node.op.name not in QUANTIZABLE_OPS:
            continue
        if node.name in exclude:
            continue
        out.append((node, node.inputs[0], node.inputs[1]))
    return out


def calibrate(sym, arg_params, calib_data, aux_params=None,
              data_names: Sequence[str] = ("data",),
              num_calib_examples: Optional[int] = None,
              exclude: Optional[Sequence[str]] = None,
              percentile: float = 99.9, entropy: bool = False,
              method: str = "naive") -> CalibrationTable:
    """Run calibration forward passes and build a :class:`CalibrationTable`.

    A probe symbol grouping every quantizable node's data input is bound
    once and fed ``calib_data`` batches (the reference's
    ``_LayerOutputCollector`` shape); weight statistics come straight from
    ``arg_params``.  ``entropy=True`` additionally computes KL-optimal
    thresholds (slower; reuses the reference algorithm in
    ``contrib.quantization``)."""
    from ..module import Module
    from ..symbol.symbol import Symbol, Group
    from ..symbol.graph import SymbolEntry

    exclude = set(exclude or ())
    nodes = _quantizable_nodes(sym, exclude)
    acts: Dict[str, dict] = {}
    samples: Dict[str, List[_np.ndarray]] = {}
    weights: Dict[str, dict] = {}

    for node, _data_e, weight_e in nodes:
        wnode = weight_e.node
        if wnode.kind == "var" and wnode.name in arg_params:
            arr = arg_params[wnode.name]
            a = arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)
            weights[wnode.name] = {
                "absmax": [float(v) for v in weight_channel_absmax(a)],
                "shape": [int(d) for d in a.shape]}

    probes = [Symbol([SymbolEntry(n.inputs[0].node, n.inputs[0].index)])
              for n, _d, _w in nodes]
    names = [n.name for n, _d, _w in nodes]
    if probes:
        from .. import nd as _nd

        arg_params = {k: (v if hasattr(v, "asnumpy") else _nd.array(v))
                      for k, v in arg_params.items()}
        if aux_params:
            aux_params = {k: (v if hasattr(v, "asnumpy") else _nd.array(v))
                          for k, v in aux_params.items()}
        probe = Group(probes)
        mod = Module(probe, data_names=list(data_names), label_names=None)
        n_seen = 0
        for batch in calib_data:
            if not mod.binded:
                mod.bind(data_shapes=calib_data.provide_data,
                         for_training=False)
                mod.set_params(arg_params, aux_params, allow_missing=True,
                               allow_extra=True)
            mod.forward(batch, is_train=False)
            for name, out in zip(names, mod.get_outputs()):
                x = out.asnumpy().astype(_np.float32)
                ent = acts.setdefault(name, {
                    "min": float("inf"), "max": float("-inf"),
                    "absmax": 0.0, "samples": 0})
                ent["min"] = min(ent["min"], float(x.min()))
                ent["max"] = max(ent["max"], float(x.max()))
                ent["absmax"] = max(ent["absmax"],
                                    float(_np.abs(x).max()))
                ent["samples"] += int(x.size)
                flat = _np.abs(x).ravel()
                samples.setdefault(name, []).append(flat[:_SAMPLE_CAP])
            n_seen += batch.data[0].shape[0]
            if num_calib_examples and n_seen >= num_calib_examples:
                break
    for name, chunks in samples.items():
        allx = _np.concatenate(chunks)
        acts[name]["percentile"] = float(_np.percentile(allx, percentile)) \
            if allx.size else 0.0
    if entropy:
        from ..contrib.quantization import calib_thresholds_entropy

        thresholds = calib_thresholds_entropy(
            {n: chunks for n, chunks in samples.items()})
        for name, t in thresholds.items():
            acts[name]["entropy"] = float(t)
    return CalibrationTable(activations=acts, weights=weights, method=method)


def calibrate_module(mod, calib_data, **kwargs) -> CalibrationTable:
    """:func:`calibrate` over a bound Module with initialized params."""
    if not (getattr(mod, "binded", False)
            and getattr(mod, "params_initialized", False)):
        raise MXNetError(
            "calibrate_module: Module must be bound with initialized params")
    arg_params, aux_params = mod.get_params()
    return calibrate(mod.symbol, arg_params, calib_data,
                     aux_params=aux_params,
                     data_names=list(mod.data_names), **kwargs)
