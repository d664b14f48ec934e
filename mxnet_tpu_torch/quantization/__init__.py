"""``mx.quantization``: int8 serving (PyTorch counterpart of
``mxnet_tpu/quantization/``).

- **Calibration** (:mod:`.calibrate`): a bound Module run over a
  calibration iterator, per-tensor activation statistics of every
  FullyConnected and Convolution input and per-channel weight absmax, kept
  as a checksummed :class:`CalibrationTable` (the reference's file).
- **Graph conversion** (:mod:`.convert`): the symbol rewritten over the
  shared rewrite engine (``symbol/rewrite.py``, AMP's) into int8 pairs
  with static calibrated scales, int8 weights stored once with
  per-channel scales.  Served through ``ServingConfig(quantize="int8")``
  or ``TPUMX_QUANT=int8``.

The int8 paged KV cache of the generation engine is
``GenerationConfig(kv_dtype="int8")`` (``serving/generation``).
"""
from __future__ import annotations

import os
from typing import Optional

from ..base import MXNetError
from .calibrate import (CalibrationTable, calibrate, calibrate_module,
                        weight_channel_absmax)
from .convert import (QUANTIZABLE_OPS, convert_symbol, count_quantized_nodes,
                      quantize_weights)

__all__ = ["CalibrationTable", "calibrate", "calibrate_module",
           "convert_symbol", "quantize_weights", "count_quantized_nodes",
           "weight_channel_absmax", "QUANTIZABLE_OPS", "enabled",
           "active_dtype"]


def enabled() -> bool:
    """Whether serving quantization is on through the environment
    (``TPUMX_QUANT=int8``; off by default, and ``TPUMX_QUANT=0`` is the
    same as unset)."""
    return active_dtype() is not None


def active_dtype() -> Optional[str]:
    """The quantized dtype ``TPUMX_QUANT`` selects, or None when off:
    ``int8`` (also ``1``); ``0``/``none``/``off``/``false``/unset
    disable; anything else raises."""
    raw = os.environ.get("TPUMX_QUANT", "").strip().lower()
    if raw in ("", "0", "none", "off", "false"):
        return None
    if raw in ("int8", "1"):
        return "int8"
    raise MXNetError(
        f"TPUMX_QUANT={raw!r}: expected 'int8' (or '0'/'none' to disable)")
