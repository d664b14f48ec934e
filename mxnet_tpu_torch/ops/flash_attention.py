"""Flash attention: the forward with its log-sum-exp and both backward passes.

PyTorch counterpart of ``mxnet_tpu/ops/flash_attention.py``: the
``_fwd_kernel`` (forward, out and per-row lse), ``_dq_kernel`` and
``_dkv_kernel`` Pallas kernels behind ``flash_attention``.  For CUDA tensors
each of the three wrappers below launches its hand-written CUDA kernel
(``csrc/flash_attention.cu``); for CPU tensors it takes its plain version.
A CUDA tensor a kernel does not take raises; nothing falls back.

:func:`flash_attention` is a ``torch.autograd.Function``: its forward
launches the forward kernel and saves ``q, k, v, out, lse``; its backward
computes ``delta = rowsum(g * out)`` in f32 with torch ops (plain jnp in
the reference too) and launches the dQ and the dK/dV kernels.

Semantics shared by kernels and plain versions, as in the reference: q is
scaled in f32 before the product, scores and accumulation are f32, a
masked score is ``-1e30`` (probability 0), ``out = acc / max(l, 1e-30)``
in the input dtype, ``lse = m + log(max(l, 1e-30))`` in f32, and the
gradients come back in their inputs' dtypes.  The reference's
``select_flash_blocks`` and ``TPUMX_FLASH_BLOCK_Q/K`` size tiles for TPU
VMEM and are not carried over: the CUDA kernels tile by 64 rows.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_backward", "flash_attention_forward_reference",
           "flash_attention_backward_reference",
           "flash_attention_dq_reference", "flash_attention_dkv_reference",
           "flash_delta"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_QKV = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
_ARGS_FWD = _QKV + [ctypes.c_void_p] * 2 + _TAIL
_ARGS_DQ = _QKV + [ctypes.c_void_p] * 4 + _TAIL
_ARGS_DKV = _QKV + [ctypes.c_void_p] * 5 + _TAIL


def _scale(d: int, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


# -- plain versions ---------------------------------------------------------
def _scores(q, k, causal: bool, scale: float):
    """(q * scale) k^T in f32 over (B, T, H, D) inputs -> (B, H, T, T)
    with masked entries at -1e30, and the scaled f32 q."""
    qs = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        t = q.shape[1]
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, _NEG)
    return s, qs


def flash_attention_forward_reference(q, k, v, causal: bool = False,
                                      scale=None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)`` with out
    (B, T, H, D) in q's dtype and lse (B, H, T) float32."""
    scale = _scale(q.shape[-1], scale)
    s, _ = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = acc / den.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(den))[..., 0]


def flash_delta(out, g):
    """``rowsum(g * out)`` in f32, (B, T, H, D) -> (B, H, T) contiguous."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, g, lse, delta, causal, scale):
    s, qs = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None]), qs


def flash_attention_dq_reference(q, k, v, g, lse, delta, causal, scale):
    """Plain PyTorch version of the dQ kernel (:func:`flash_attention_dq`)."""
    _, ds, _ = _probs_and_ds(q, k, v, g, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, g, lse, delta, causal, scale):
    """Plain PyTorch version of the dK/dV kernel
    (:func:`flash_attention_dkv`)."""
    p, ds, qs = _probs_and_ds(q, k, v, g, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, g,
                                       causal: bool = False, scale=None):
    """Plain PyTorch version of the two backward kernels: ``(dq, dk, dv)``
    from the forward's ``out`` and ``lse`` and the output gradient ``g``,
    recomputing ``p = exp(s - lse)`` as the kernels do."""
    scale = _scale(q.shape[-1], scale)
    delta = flash_delta(out, g)
    dq = flash_attention_dq_reference(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv_reference(q, k, v, g, lse, delta, causal,
                                           scale)
    return dq, dk, dv


# -- kernel wrappers --------------------------------------------------------
def _device_ok(t, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise MXNetError(f"{what}: unsupported device {t.device}")
    return True


def _check_qkv(q, k, v, what: str):
    """Checks q, k, v for the kernels and returns them with one shared
    stride set: views that share their strides (the LM's split qkv
    product) pass as they are, others are made contiguous."""
    if q.dim() != 4:
        raise MXNetError(f"{what}: q must be (B, T, H, D), got "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise MXNetError(
                f"{what}: {name} must match q {tuple(q.shape)} {q.dtype} on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if q.dtype not in _DTYPES:
        raise MXNetError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if q.shape[-1] not in _HEAD_DIMS:
        raise MXNetError(f"{what}: head dim {q.shape[-1]} not supported "
                         f"{_HEAD_DIMS}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _check(name: str, t, shape, dtype, device, what: str):
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise MXNetError(
            f"{what}: {name} must be a contiguous {tuple(shape)} {dtype} "
            f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def _launch_args(q, causal, scale):
    B, T, H, D = q.shape
    return (B, T, H, D, float(scale), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_forward(q, k, v, causal: bool = False, scale=None):
    """Forward kernel: ``(out, lse)`` for (B, T, H, D) q, k, v (out in q's
    dtype, lse (B, H, T) float32).  CUDA tensors (float32 or bfloat16,
    D in 16/32/64/128) launch ``tpumx_flash_fwd``, counted in
    ``flash_attention_forward.launches``; CPU tensors take
    :func:`flash_attention_forward_reference`."""
    scale = _scale(q.shape[-1], scale)
    if not _device_ok(q, "flash_attention"):
        return flash_attention_forward_reference(q, k, v, causal, scale)
    q, k, v = _check_qkv(q, k, v, "flash_attention")
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.kernel_function("flash_attention", "tpumx_flash_fwd",
                                _ARGS_FWD)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
            out.data_ptr(), lse.data_ptr(), *_launch_args(q, causal, scale))
    _build.check_launch(rc, "flash_attention forward")
    flash_attention_forward.launches += 1
    return out, lse


def _check_bwd(q, k, v, g, lse, delta, what):
    q, k, v = _check_qkv(q, k, v, what)
    B, T, H, _ = q.shape
    _check("g", g, q.shape, q.dtype, q.device, what)
    _check("lse", lse, (B, H, T), torch.float32, q.device, what)
    _check("delta", delta, (B, H, T), torch.float32, q.device, what)
    return q, k, v


def flash_attention_dq(q, k, v, g, lse, delta, causal: bool = False,
                       scale=None):
    """dQ kernel: ``scale * sum_k p * (dp - delta) * k`` with ``p = exp(s -
    lse)`` and ``dp = g v^T``; g contiguous (B, T, H, D), lse and delta
    (B, H, T) float32.  CUDA tensors launch ``tpumx_flash_dq``, counted in
    ``flash_attention_dq.launches``; CPU tensors take the plain version."""
    scale = _scale(q.shape[-1], scale)
    if not _device_ok(q, "flash_attention dq"):
        return flash_attention_dq_reference(q, k, v, g, lse, delta, causal,
                                            scale)
    q, k, v = _check_bwd(q, k, v, g, lse, delta, "flash_attention dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    fn = _build.kernel_function("flash_attention", "tpumx_flash_dq",
                                _ARGS_DQ)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_launch_args(q, causal, scale))
    _build.check_launch(rc, "flash_attention dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, g, lse, delta, causal: bool = False,
                        scale=None):
    """dK/dV kernel: ``(dk, dv)`` with ``dv = p^T g`` and ``dk = ds^T (scale
    * q)``, the same inputs as :func:`flash_attention_dq`.  CUDA tensors
    launch ``tpumx_flash_dkv``, counted in ``flash_attention_dkv.launches``;
    CPU tensors take the plain version."""
    scale = _scale(q.shape[-1], scale)
    if not _device_ok(q, "flash_attention dkv"):
        return flash_attention_dkv_reference(q, k, v, g, lse, delta, causal,
                                             scale)
    q, k, v = _check_bwd(q, k, v, g, lse, delta, "flash_attention dkv")
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk.numel() == 0:
        return dk, dv
    fn = _build.kernel_function("flash_attention", "tpumx_flash_dkv",
                                _ARGS_DKV)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_launch_args(q, causal, scale))
    _build.check_launch(rc, "flash_attention dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_forward.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, g, causal: bool = False,
                             scale=None):
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse``: delta in f32
    with torch ops, then :func:`flash_attention_dq` and
    :func:`flash_attention_dkv` (kernels 7 and 8 on CUDA tensors)."""
    g = g.contiguous()
    delta = flash_delta(out, g)
    dq = flash_attention_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q: int = None, block_k: int = None):
    """(B, T, H, D) attention with O(T) memory and its gradient: a drop-in
    for :func:`~mxnet_tpu_torch.parallel.ring_attention.local_attention`
    (same signature and semantics, with the optional softmax scale,
    default ``1/sqrt(D)``), usable as the ``attention=`` callable of the
    transformer LM.  Returns (B, T, H, D) in q's dtype.

    ``block_q``/``block_k`` are accepted for the reference's signature and
    change nothing: the tiles are the CUDA kernels' own (64 rows)."""
    del block_q, block_k
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 _scale(q.shape[-1], scale))
