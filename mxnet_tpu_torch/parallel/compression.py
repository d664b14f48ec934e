"""2-bit gradient compression with an error-feedback residual.

PyTorch counterpart of ``mxnet_tpu/parallel/compression.py``
(reference: ``src/kvstore/gradient_compression.{h,cc,cu}``): codes
``0b01`` = ``+threshold``, ``0b10`` = ``-threshold``, ``0b00`` = 0, 16 to
a ``uint32`` word, and a residual carried between steps.  The backend is
part of the wire format, so both packed layouts are kept bit for bit:

- ``"pallas"`` (the default): the strided ``(rows, 128)`` layout of
  :mod:`..ops.twobit`, one fused CUDA kernel each way on the card;
- any other backend: 16 *consecutive* codes per word, a flat
  ``ceil(n / 16)`` word vector, in plain torch ops (the reference has no
  kernel for it either).

Packed blobs are layout-opaque: decode them with the paired
:meth:`GradientCompression.dequantize`.
"""
from __future__ import annotations

import math

import torch

from ..ops import twobit

__all__ = ["GradientCompression"]

_LANES = 16


class GradientCompression:
    def __init__(self, type="2bit", threshold=0.5, backend="pallas"):
        if type not in ("none", "2bit"):
            raise ValueError(f"unsupported compression type {type}")
        self.type = type
        self.threshold = float(threshold)
        self.backend = backend

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    def wire_params(self):
        """Everything a peer needs to decode this instance's packed blobs:
        the backend determines the packed layout, so it must match."""
        return {"type": self.type, "threshold": self.threshold,
                "backend": self.backend}

    def quantize_dequantize(self, grad, residual=None):
        """One error-feedback round trip: ``(dequantized, new_residual)``."""
        if residual is None:
            residual = torch.zeros_like(grad)
        packed, new_residual = self.quantize(grad, residual)
        return self.dequantize(packed, grad.shape, dtype=grad.dtype), \
            new_residual

    def quantize(self, grad, residual=None):
        """``(packed uint32 words, new_residual)``."""
        if self.type == "none":
            return grad, residual
        t = self.threshold
        if self.backend == "pallas":
            res = residual if residual is not None else torch.zeros_like(grad)
            return twobit.twobit_pack(grad, res, t)
        g = grad + (residual if residual is not None else 0.0)
        tt = torch.full((), t, dtype=g.dtype, device=g.device)
        pos = g >= tt
        neg = g <= -tt
        new_residual = g - tt * pos.to(g.dtype) + tt * neg.to(g.dtype)
        codes = (pos.long() | (neg.long() << 1)).reshape(-1)
        codes = torch.cat([codes, codes.new_zeros((-codes.numel()) % _LANES)])
        shifts = 2 * torch.arange(_LANES, device=g.device)
        words = (codes.view(-1, _LANES) << shifts).sum(dim=1)
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        return words.to(torch.int32).view(torch.uint32), new_residual

    def dequantize(self, packed, shape, dtype=torch.float32):
        if self.type == "none":
            return packed
        t = self.threshold
        if self.backend == "pallas":
            return twobit.twobit_unpack(packed, shape, t, dtype=dtype)
        n = math.prod(shape)
        words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        shifts = 2 * torch.arange(_LANES, device=packed.device)
        codes = ((words[:, None] >> shifts) & 3).reshape(-1)[:n]
        tt = torch.full((), t, dtype=torch.float32, device=packed.device)
        zero = torch.zeros((), dtype=torch.float32, device=packed.device)
        vals = torch.where(codes == 1, tt, torch.where(codes == 2, -tt, zero))
        return vals.to(dtype).reshape(shape)
