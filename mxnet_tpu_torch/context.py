"""Device contexts and device selection for the port's entry points.

PyTorch counterpart of ``mxnet_tpu/context.py``: ``Context`` (hashable,
comparable, a ``with`` scope that sets the default device of array
creation), ``cpu()``, ``gpu()``, ``tpu()``, ``current_context()`` and
``num_devices()``.  ``gpu(i)`` and ``tpu(i)`` are both ``cuda:i``.  The
default context is ``gpu(0)``: unlike the reference, which falls back to
the CPU, the port never moves to the CPU unless asked, and without CUDA
the default is an error that names the way out.

Every entry point takes an explicit ``device`` (or ``ctx``): a
``Context``, a ``torch.device`` or its name.  :func:`resolve_device` turns
it into a ``torch.device``; ``None`` is ``cuda``.

Precision: on a CUDA device the port turns TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
(``torch.backends.cudnn.allow_tf32``), so float32 results are full float32
like the JAX reference's.  CPU devices leave torch's global flags alone.
"""
from __future__ import annotations

import threading
from typing import Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context",
           "default_context", "num_devices", "resolve_device"]


class Context:
    """A device context: ``Context("gpu", 0)`` or ``mx.gpu(0)``."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                  "tpu": 6}

    _tls = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
            return
        if device_type not in self.devtype2id:
            raise ValueError(
                f"unknown device type {device_type!r}; expected one of "
                f"{list(self.devtype2id)}")
        self.device_type = device_type
        self.device_id = device_id

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context denotes (``cuda:i`` for gpu
        and tpu)."""
        if self.device_type.startswith("cpu"):
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __enter__(self) -> "Context":
        if not hasattr(Context._tls, "stack"):
            Context._tls.stack = []
        Context._tls.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        stack = getattr(Context._tls, "stack", None)
        if not stack:
            raise RuntimeError(
                "Context.__exit__ without a matching __enter__")
        stack.pop()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The reference's accelerator context; ``cuda:device_id`` here."""
    return Context("tpu", device_id)


def default_context() -> Context:
    """``gpu(0)``; raises without CUDA (pass ``ctx=mx.cpu()`` instead)."""
    resolve_device(None)
    return gpu(0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context, else the default."""
    stack = getattr(Context._tls, "stack", None)
    if stack:
        return stack[-1]
    return default_context()


def num_devices() -> int:
    return torch.cuda.device_count()


def context_of(device: torch.device) -> Context:
    """The context of a tensor's device (``cuda:i`` is ``gpu(i)``)."""
    if device.type == "cpu":
        return cpu(0)
    return gpu(device.index or 0)


DeviceLike = Union[str, torch.device, Context, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` for ``device``; ``None`` means ``cuda``."""
    if isinstance(device, Context):
        device = device.torch_device
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "CUDA is not available; pass device=\"cpu\" (or "
                "ctx=mx.cpu()) to run on the CPU")
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
