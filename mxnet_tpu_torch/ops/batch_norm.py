"""Train-mode BatchNorm over the last (channel) axis.

PyTorch counterpart of ``mxnet_tpu/ops/pallas_kernels.py``
``bn_train_fused`` / ``_bn_train_reference`` (the ``_bn_stats_kernel`` and
``_bn_norm_kernel`` Pallas kernels).  Two wrappers, each launching one
hand-written CUDA kernel of ``csrc/batch_norm.cu`` for a CUDA tensor and
taking its plain version only for a CPU tensor (there is no other
fallback: a CUDA tensor the kernel does not take raises):

- :func:`bn_stats` — per-channel f32 ``mean`` and biased ``var`` of an
  ``(M, C)`` activation in one read, recentred on row 0 as the TPU kernel
  is (``mean_c = s1/M``, ``var = max(s2/M - mean_c**2, 0)``,
  ``mean = mean_c + pivot``);
- :func:`bn_normalize` — ``x * scale + shift`` per channel with f32
  ``scale``/``shift``, in ``x``'s dtype: one read and one write.

:func:`bn_train_fused` chains them as ``_bn_fused_fwd`` does: ``scale =
gamma * rsqrt(var + eps)``, ``shift = beta - mean * scale``.  Its gradient
is the reference's: ``_bn_fused_bwd`` is ``jax.vjp`` of the plain
``_bn_train_reference``, so a ``torch.autograd.Function`` runs the kernels
forward and, in its backward, differentiates :func:`bn_train_reference`
recomputed from the saved ``x, gamma, beta`` for all three outputs.  There
is no backward kernel, as the reference has none.  The Function is taken
only when grad mode is on and an input requires grad.

Over the ranks of a data-parallel batch, ``sync`` (a differentiable
function that stacks every rank's tensor on a new dim 0) makes the
statistics the whole batch's: each rank takes its block's from the stats
kernel, the ranks' ``(mean, var)`` are gathered and combined by Chan's
formula for equal counts (an exact identity at one rank, value and
gradient), and the normalize kernel applies the result.  The plain
version does the same between its statistics and its normalize, so the
backward stays its vjp.

The reference gates its kernels behind ``MXTPU_BN_PALLAS=1``, ``C % 128 ==
0`` and ``M % 8 == 0`` (TPU lane and tiling rules); none of those carries
over: every channels-last training BatchNorm on a CUDA tensor runs the
kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["bn_train_fused", "bn_train_reference", "bn_stats",
           "bn_stats_reference", "bn_normalize", "bn_normalize_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
_NORM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
THREADS = 256          # threads per block of both kernels
STATS_BLOCKS = 1024    # stats: about this many blocks in all ...
MIN_ROWS_PER_THREAD = 16   # ... but at least this many rows per thread
NORM_ROWS_PER_THREAD = 8


def tiling(c: int, itemsize: int, aligned: bool = True):
    """``(vec, lanes, tiles, step)`` of both kernels for C channels: ``vec``
    channels per 16-byte load (1 when C is no multiple of it or x is not
    16-byte aligned), ``lanes`` threads across a row (a power of two up to
    32), ``tiles`` channel tiles of ``lanes * vec``, ``step`` rows a block
    covers per pass (256 / lanes)."""
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    lanes = min(32, 1 << max(0, math.ceil(math.log2(-(-c // vec)))))
    return vec, lanes, -(-c // (lanes * vec)), THREADS // lanes


def stats_splits(m: int, tiles: int, step: int):
    """``(splits, rows_per_split)`` of the stats kernel: M cut into row
    ranges so that about :data:`STATS_BLOCKS` blocks run in all, each
    thread summing at least :data:`MIN_ROWS_PER_THREAD` rows."""
    splits = max(1, min(-(-STATS_BLOCKS // tiles),
                        -(-m // (step * MIN_ROWS_PER_THREAD))))
    rows = -(-m // splits)
    return -(-m // rows), rows


def bn_stats_reference(x2d):
    """Plain PyTorch statistics of a contiguous ``(M, C)`` tensor: f32
    ``(mean, var)`` by the kernel's formula."""
    xf = x2d.float()
    pivot = xf[0]
    xc = xf - pivot
    mean_c = xc.mean(dim=0)
    var = ((xc * xc).mean(dim=0) - mean_c * mean_c).clamp_min(0.0)
    return mean_c + pivot, var


def bn_normalize_reference(x2d, scale, shift):
    """Plain PyTorch ``x * scale + shift`` in f32, cast to ``x``'s dtype."""
    return (x2d.float() * scale + shift).to(x2d.dtype)


def _combine(mean, var, sync):
    """The whole batch's f32 ``(mean, var)`` from each rank's, by Chan's
    combination of equal counts: the mean of the means, and the mean of
    ``var + (mean - whole mean)**2``.  ``sync(t)`` stacks every rank's
    ``t`` on a new dim 0."""
    g = sync(torch.stack([mean, var]))
    whole = g[:, 0].mean(0)
    return whole, (g[:, 1] + (g[:, 0] - whole).square()).mean(0)


def bn_train_reference(x, gamma, beta, eps: float = 1e-5, sync=None):
    """Plain PyTorch train-mode BatchNorm over the last axis of ``x`` (any
    rank): ``(out, mean, var)``, ``_bn_train_reference``'s arithmetic —
    f32 pivot one-pass statistics, ``out`` in ``x``'s dtype.  The pivot is
    a constant for the gradient (``stop_gradient`` in the reference).
    With ``sync`` the statistics are combined over the ranks (module
    doc)."""
    xf = x.float()
    red = tuple(range(x.ndim - 1))
    pivot = xf[(0,) * (x.ndim - 1)].detach()
    xc = xf - pivot
    mean_c = xc.mean(dim=red)
    var = ((xc * xc).mean(dim=red) - mean_c * mean_c).clamp_min(0.0)
    mean = mean_c + pivot
    if sync is not None:
        mean, var = _combine(mean, var, sync)
    inv = torch.rsqrt(var + eps)
    out = ((xf - mean) * (gamma.float() * inv) + beta.float()).to(x.dtype)
    return out, mean, var


def _check_2d(x2d, what: str):
    if x2d.dtype not in _DTYPES:
        raise MXNetError(f"{what}: dtype {x2d.dtype} not supported "
                         f"(float32, bfloat16)")
    if x2d.ndim != 2 or not x2d.is_contiguous():
        raise MXNetError(f"{what}: x must be a contiguous (M, C) tensor")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def bn_stats(x2d):
    """Per-channel f32 ``(mean, var)`` of a contiguous ``(M, C)`` f32 or
    bf16 tensor.  CUDA tensors launch the stats kernel (counted in
    ``bn_stats.launches``); CPU tensors take :func:`bn_stats_reference`."""
    if x2d.device.type == "cpu":
        return bn_stats_reference(x2d)
    if x2d.device.type != "cuda":
        raise MXNetError(f"bn_stats: unsupported device {x2d.device}")
    _check_2d(x2d, "bn_stats")
    m, c = x2d.shape
    mean = torch.empty(c, dtype=torch.float32, device=x2d.device)
    var = torch.empty_like(mean)
    if m == 0 or c == 0:
        return mean.fill_(float("nan")), var.fill_(float("nan"))
    vec, lanes, tiles, step = tiling(c, x2d.element_size(), _aligned(x2d))
    splits, rows = stats_splits(m, tiles, step)
    part = torch.empty(2, splits, c, dtype=torch.float32, device=x2d.device)
    fn = _build.kernel_function("batch_norm", "tpumx_bn_stats",
                                _STATS_ARGTYPES)
    rc = fn(x2d.data_ptr(), part.data_ptr(), mean.data_ptr(), var.data_ptr(),
            m, c, vec, lanes, rows, splits, _DTYPES[x2d.dtype],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check_launch(rc, "bn_stats")
    bn_stats.launches += 1
    return mean, var


bn_stats.launches = 0


def bn_normalize(x2d, scale, shift):
    """``x * scale + shift`` per channel of a contiguous ``(M, C)`` f32 or
    bf16 tensor, with contiguous ``(C,)`` f32 ``scale``/``shift``; a new
    tensor in ``x``'s dtype.  CUDA tensors launch the normalize kernel
    (counted in ``bn_normalize.launches``); CPU tensors take
    :func:`bn_normalize_reference`."""
    if x2d.device.type == "cpu":
        return bn_normalize_reference(x2d, scale, shift)
    if x2d.device.type != "cuda":
        raise MXNetError(f"bn_normalize: unsupported device {x2d.device}")
    _check_2d(x2d, "bn_normalize")
    m, c = x2d.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if t.device != x2d.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise MXNetError(
                f"bn_normalize: {name} must be a contiguous ({c},) float32 "
                f"tensor on {x2d.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    out = torch.empty_like(x2d)
    if m == 0 or c == 0:
        return out
    vec, lanes, _, step = tiling(c, x2d.element_size(), _aligned(x2d, out))
    fn = _build.kernel_function("batch_norm", "tpumx_bn_normalize",
                                _NORM_ARGTYPES)
    rc = fn(x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), m, c, vec, lanes, step * NORM_ROWS_PER_THREAD,
            _DTYPES[x2d.dtype],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check_launch(rc, "bn_normalize")
    bn_normalize.launches += 1
    return out


bn_normalize.launches = 0


def _launch(x, gamma, beta, eps: float, sync=None):
    """The two kernels: ``_bn_fused_fwd``'s forward, with ``sync`` the
    statistics combined over the ranks in between."""
    x2d = x.view(-1, x.shape[-1])
    mean, var = bn_stats(x2d)
    if sync is not None:
        mean, var = _combine(mean, var, sync)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return bn_normalize(x2d, scale, shift).view(x.shape), mean, var


class _BatchNormFn(torch.autograd.Function):
    """Kernel forward; backward = vjp of :func:`bn_train_reference` for
    all three outputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, sync=None):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.sync = eps, sync
        return _launch(x, gamma, beta, eps, sync)

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = bn_train_reference(*leaves, ctx.eps, ctx.sync)
        dx, dgamma, dbeta = torch.autograd.grad(outs, leaves,
                                                (g_out, g_mean, g_var))
        return dx, dgamma, dbeta, None, None


def bn_train_fused(x, gamma, beta, eps: float = 1e-5, sync=None):
    """Train-mode BatchNorm over the LAST axis of a contiguous ``x`` (any
    rank, float32 or bfloat16) with ``(C,)`` ``gamma``/``beta`` (any float
    dtype, used in f32): ``(out, mean, var)`` — ``out`` in ``x``'s dtype,
    the batch ``mean`` and biased ``var`` in f32 — differentiable in ``x``,
    ``gamma`` and ``beta``.

    CUDA tensors run the stats and normalize kernels; CPU tensors
    :func:`bn_train_reference`.  ``sync`` makes the statistics those of
    every rank's batch (module doc)."""
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"bn_train_fused: unsupported device {x.device}")
    if x.ndim < 1:
        raise MXNetError("bn_train_fused: x needs a channel axis")
    c = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or tuple(t.shape) != (c,) \
                or not t.is_floating_point():
            raise MXNetError(
                f"bn_train_fused: {name} must be a ({c},) float tensor on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise MXNetError("bn_train_fused: x must be contiguous with "
                         "channels last")
    if x.device.type == "cpu":
        return bn_train_reference(x, gamma, beta, eps, sync)
    if x.dtype not in _DTYPES:
        raise MXNetError(f"bn_train_fused: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _BatchNormFn.apply(x, gamma, beta, float(eps), sync)
    return _launch(x, gamma, beta, float(eps), sync)
