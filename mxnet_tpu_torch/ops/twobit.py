"""2-bit gradient compression with error feedback, in the "pallas" layout.

PyTorch counterpart of ``mxnet_tpu/ops/pallas_kernels.py``
``twobit_pack`` / ``twobit_unpack`` (the ``_twobit_pack_kernel`` and
``_twobit_unpack_kernel`` Pallas kernels).  Two wrappers, each launching
one hand-written CUDA kernel of ``csrc/twobit.cu`` for a CUDA tensor and
taking its plain version only for a CPU tensor (there is no other
fallback: a CUDA tensor the kernel does not take raises):

- :func:`twobit_pack` — ``g = grad + residual``; code ``0b01`` where ``g
  >= t``, ``0b10`` where ``g <= -t``; the new residual ``g - sel(g >= t, t,
  0) + sel(g <= -t, t, 0)``; codes packed 16 to a ``uint32`` word, word
  ``j`` of row ``r`` holding element ``r * 2048 + i * 128 + j`` in bits
  ``2i..2i+1``.  The flat input is taken as zero-padded to whole rows of
  2048 (to a multiple of 64 rows past 64), as the reference pads it, so
  the packed words are ``(rows, 128)`` ``uint32`` and equal the
  reference's bit for bit, padded words included.
- :func:`twobit_unpack` — the inverse: code 1 gives ``+t``, code 2 ``-t``,
  anything else 0, in ``dtype`` (``t`` rounded to it), cut to ``shape``.

The kernels take float32 gradients and residuals (the trainer's and the
kvstore's) and write float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["twobit_pack", "twobit_unpack", "twobit_pack_reference",
           "twobit_unpack_reference", "packed_rows"]

LANES = 16                  # 2-bit codes per uint32 word
WORDS_PER_ROW = 128
ROW = LANES * WORDS_PER_ROW  # elements per packed row
ROW_BLOCK = 64              # rows per program of the TPU kernel

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PACK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_float, ctypes.c_void_p]
_UNPACK_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def packed_rows(n: int) -> int:
    """Rows of 128 words that pack ``n`` elements: whole rows of 2048, a
    multiple of 64 rows past 64 (the reference's padding)."""
    rows = -(-n // ROW)
    if rows > ROW_BLOCK:
        rows = -(-rows // ROW_BLOCK) * ROW_BLOCK
    return rows


def _rounded(threshold: float, dtype: torch.dtype) -> float:
    """``threshold`` rounded to ``dtype`` (``jnp.full``'s rounding)."""
    return torch.tensor(float(threshold), dtype=dtype).item()


def _scalar(threshold: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``threshold`` rounded to ``dtype``, as a 0-d tensor on ``device``
    (a fill, not a host-to-device copy, so it can be graph-captured)."""
    return torch.full((), _rounded(threshold, dtype), dtype=dtype,
                      device=device)


def twobit_pack_reference(grad, residual, threshold):
    """Plain PyTorch pack: ``(packed (rows, 128) uint32, new residual like
    grad)``, by the reference's arithmetic on its zero-padded input."""
    n = grad.numel()
    rows = packed_rows(n)
    t = _scalar(threshold, grad.dtype, grad.device)
    g = grad.reshape(-1) + residual.reshape(-1)
    g = torch.cat([g, g.new_zeros(rows * ROW - n)])
    pos = g >= t
    neg = g <= -t
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    newres = g - torch.where(pos, t, zero) + torch.where(neg, t, zero)
    # uint32 has few ops (no shifts on the CPU): shift in int64, then
    # reinterpret the low 32 bits
    codes = (pos.long() | (neg.long() << 1)).view(rows, LANES, WORDS_PER_ROW)
    shifts = 2 * torch.arange(LANES, device=g.device).view(1, LANES, 1)
    words = (codes << shifts).sum(dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    packed = words.to(torch.int32).view(torch.uint32)
    return packed, newres[:n].view(grad.shape)


def twobit_unpack_reference(packed, shape, threshold, dtype=torch.float32):
    """Plain PyTorch unpack of ``(rows, 128)`` words into ``shape``."""
    n = math.prod(shape)
    t = _scalar(threshold, dtype, packed.device)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    shifts = 2 * torch.arange(LANES, device=packed.device).view(1, LANES, 1)
    codes = (words[:, None, :] >> shifts) & 3
    zero = torch.zeros((), dtype=dtype, device=packed.device)
    vals = torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))
    return vals.reshape(-1)[:n].reshape(shape)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def twobit_pack(grad, residual, threshold):
    """Fused 2-bit quantize with error feedback: ``(packed (rows, 128)
    uint32, new residual like grad)``.  CUDA tensors (contiguous float32
    ``grad`` and ``residual`` of one shape) launch the pack kernel, counted
    in ``twobit_pack.launches``; CPU tensors take
    :func:`twobit_pack_reference`."""
    if grad.device.type == "cpu":
        return twobit_pack_reference(grad, residual, threshold)
    if grad.device.type != "cuda":
        raise MXNetError(f"twobit_pack: unsupported device {grad.device}")
    for name, t in (("grad", grad), ("residual", residual)):
        if t.device != grad.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != grad.shape:
            raise MXNetError(
                f"twobit_pack: {name} must be a contiguous float32 tensor of "
                f"shape {tuple(grad.shape)} on {grad.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    n = grad.numel()
    rows = packed_rows(n)
    packed = torch.empty(rows, WORDS_PER_ROW, dtype=torch.int32,
                         device=grad.device).view(torch.uint32)
    newres = torch.empty_like(grad)
    if rows == 0:
        return packed, newres
    fn = _build.kernel_function("twobit", "tpumx_twobit_pack", _PACK_ARGTYPES)
    rc = fn(grad.data_ptr(), residual.data_ptr(), packed.data_ptr(),
            newres.data_ptr(), n, rows * WORDS_PER_ROW,
            _rounded(threshold, torch.float32), _stream(grad))
    _build.check_launch(rc, "twobit_pack")
    twobit_pack.launches += 1
    return packed, newres


twobit_pack.launches = 0


def twobit_unpack(packed, shape, threshold, dtype=torch.float32):
    """Inverse of :func:`twobit_pack`: ``(rows, 128)`` words into a new
    tensor of ``shape`` and ``dtype`` (float32 or bfloat16 on the card).
    CUDA tensors launch the unpack kernel, counted in
    ``twobit_unpack.launches``; CPU tensors take
    :func:`twobit_unpack_reference`."""
    shape = tuple(int(s) for s in shape)
    if packed.device.type == "cpu":
        return twobit_unpack_reference(packed, shape, threshold, dtype)
    if packed.device.type != "cuda":
        raise MXNetError(f"twobit_unpack: unsupported device {packed.device}")
    if dtype not in _OUT_DTYPES:
        raise MXNetError(f"twobit_unpack: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    if packed.dtype != torch.uint32 or packed.ndim != 2 \
            or packed.shape[1] != WORDS_PER_ROW or not packed.is_contiguous():
        raise MXNetError(f"twobit_unpack: packed must be contiguous "
                         f"(rows, {WORDS_PER_ROW}) uint32 words, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    n = math.prod(shape)
    if n > packed.shape[0] * ROW:
        raise MXNetError(f"twobit_unpack: {packed.shape[0]} rows hold "
                         f"{packed.shape[0] * ROW} codes, not {n}")
    out = torch.empty(shape, dtype=dtype, device=packed.device)
    if n == 0:
        return out
    fn = _build.kernel_function("twobit", "tpumx_twobit_unpack",
                                _UNPACK_ARGTYPES)
    rc = fn(packed.data_ptr(), out.data_ptr(), n, packed.numel(),
            _rounded(threshold, dtype), _OUT_DTYPES[dtype],
            _stream(packed))
    _build.check_launch(rc, "twobit_unpack")
    twobit_unpack.launches += 1
    return out


twobit_unpack.launches = 0
