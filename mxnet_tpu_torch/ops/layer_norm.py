"""Fused LayerNorm(+GELU) over the last axis.

PyTorch counterpart of ``mxnet_tpu/ops/pallas_kernels.py``
``layer_norm_fused`` / ``_ln_reference`` (the ``_ln_kernel`` Pallas
kernel).  :func:`layer_norm_fused` launches the hand-written CUDA kernel
``csrc/layer_norm.cu`` for a CUDA tensor and takes the plain version,
:func:`layer_norm_reference`, only for a CPU tensor.  There is no other
fallback: a CUDA tensor the kernel does not take raises.

Both compute the statistics in f32 in the pivot-recentred one-pass form of
the TPU kernel (one read gives sum and sum of squares of ``x - x[..., 0]``),
and the optional GELU epilogue is the tanh approximation (``jax.nn.gelu``'s
default).

The gradient is the reference's: ``_ln_fused_bwd`` there is ``jax.vjp`` of
the plain ``_ln_reference``, so here a ``torch.autograd.Function`` runs the
CUDA kernel forward and, in its backward, differentiates
:func:`layer_norm_reference` recomputed from the saved ``x, gamma, beta``
with autograd.  There is no backward kernel, as the reference has none.
The Function is taken only when grad mode is on and an input requires
grad, so inference calls launch the kernel alone.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build

__all__ = ["layer_norm_fused", "layer_norm_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5,
                         gelu: bool = False):
    """Plain PyTorch LayerNorm over the last axis, the kernel's arithmetic:
    f32 pivot one-pass statistics, f32 affine and GELU, cast back to
    ``x``'s dtype."""
    xf = x.float()
    # the pivot is a constant for the gradient (stop_gradient in the
    # reference), so the vjp takes no path through it
    xc = xf - xf[..., :1].detach()
    mean_c = xc.mean(dim=-1, keepdim=True)
    var = ((xc * xc).mean(dim=-1, keepdim=True)
           - mean_c * mean_c).clamp_min(0.0)
    out = (xc - mean_c) * torch.rsqrt(var + eps) * gamma.float() \
        + beta.float()
    if gelu:
        out = F.gelu(out, approximate="tanh")
    return out.to(x.dtype)


def _launch(x, gamma, beta, eps: float, gelu: bool):
    out = torch.empty_like(x)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    fn = _build.kernel_function("layer_norm", "tpumx_layer_norm", _ARGTYPES)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            rows, c, float(eps), int(bool(gelu)), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "layer_norm_fused")
    layer_norm_fused.launches += 1
    return out


class _LayerNormFn(torch.autograd.Function):
    """Kernel forward; backward = vjp of :func:`layer_norm_reference`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, gelu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.gelu = eps, gelu
        return _launch(x, gamma, beta, eps, gelu)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm_reference(*leaves, ctx.eps, ctx.gelu)
        dx, dgamma, dbeta = torch.autograd.grad(out, leaves, g)
        return dx, dgamma, dbeta, None, None


def layer_norm_fused(x, gamma, beta, eps: float = 1e-5, gelu: bool = False):
    """LayerNorm over the LAST axis of ``x`` (any rank) with ``(C,)``
    ``gamma``/``beta`` in ``x``'s dtype; ``gelu=True`` applies the tanh-GELU
    epilogue in the same pass.  Returns a new tensor in ``x``'s dtype,
    differentiable in ``x``, ``gamma`` and ``beta``.

    CUDA tensors (contiguous, float32 or bfloat16) go through the CUDA
    kernel, counted in ``layer_norm_fused.launches``; CPU tensors through
    :func:`layer_norm_reference`."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps, gelu)
    if x.device.type != "cuda":
        raise MXNetError(f"layer_norm_fused: unsupported device {x.device}")
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise MXNetError(f"layer_norm_fused: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != x.dtype \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise MXNetError(
                f"layer_norm_fused: {name} must be a contiguous ({c},) "
                f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise MXNetError("layer_norm_fused: x must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNormFn.apply(x, gamma, beta, eps, gelu)
    return _launch(x, gamma, beta, eps, gelu)


layer_norm_fused.launches = 0
