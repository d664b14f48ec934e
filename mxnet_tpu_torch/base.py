"""Shared small utilities: the framework error type, typed env lookup and
the dtype names.

PyTorch counterpart of ``mxnet_tpu/base.py`` (only the parts the port
uses); kept as its own copy so this package never imports the JAX one.
Dtypes go by the reference's names (numpy's, plus ``"bfloat16"``, which
numpy itself lacks).
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "getenv", "torch_dtype", "dtype_name", "np_dtype"]


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


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "uint8": torch.uint8, "int8": torch.int8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "uint32": torch.uint32,
                 "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` for a dtype name, numpy dtype or torch dtype
    (``None``: float32, the reference's default)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
        name = getattr(dtype, "name", None)
        if name is None:
            try:
                name = np.dtype(dtype).name
            except TypeError:
                name = str(dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """The reference's name of a dtype (``"float32"``, ``"bfloat16"``...)."""
    return _NAMES[torch_dtype(dtype)]


def np_dtype(dtype):
    """The numpy dtype of a dtype; ``"bfloat16"`` (the name) for
    bfloat16, which numpy has no dtype for."""
    name = dtype_name(dtype)
    return name if name == "bfloat16" else np.dtype(name)
