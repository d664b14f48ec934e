"""Shared small utilities: the framework error type and typed env lookup.

PyTorch counterpart of ``mxnet_tpu/base.py`` (only the parts the serving
slice uses); kept as its own copy so this package never imports the JAX one.
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "getenv"]


class MXNetError(RuntimeError):
    """Framework error type (reference: ``dmlc::Error`` surfaced as MXNetError)."""


def getenv(name: str, default):
    """Typed env lookup; the cast follows the type of ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw
