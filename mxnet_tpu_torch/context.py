"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``.  When the caller gives
none, the device is ``cuda``; without CUDA that is an error that names the
way out (``device="cpu"``), never a silent move to the CPU.

Precision: on a CUDA device the port turns TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
(``torch.backends.cudnn.allow_tf32``), so float32 results are full float32
like the JAX reference's.  CPU devices leave torch's global flags alone.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` for ``device``; ``None`` means ``cuda``."""
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "CUDA is not available; pass device=\"cpu\" to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but CUDA is not available; pass "
                f"device=\"cpu\" to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
