"""Contrib ops (PyTorch counterpart of ``mxnet_tpu/ops/contrib.py``):
flash attention and the non-detection ``_contrib_*`` ops (count sketch,
FFT, ``quadratic``, ``arange_like``, ``index_copy``, ``getnnz``,
``div_sqrt_dim``, ``SyncBatchNorm``).  The detection ops, the deformable
and position-sensitive poolings and CTC are ROADMAP.md Queue 1, item 6g.

``flash_attention`` over (B, T, H, D) goes to
:func:`ops.flash_attention.flash_attention`: on CUDA tensors its forward
launches the flash forward kernel and its backward the dQ and dK/dV
kernels; CPU tensors take their plain versions.  ``SyncBatchNorm`` with
an ``axis_name`` takes the f32 means of x and x^2 all-reduced over that
mesh axis (``parallel.collectives``, inside ``spmd(mesh)``); without one
it is ``BatchNorm`` on axis 1.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_attention
from .registry import register

__all__ = ["contrib_flash_attention", "count_sketch", "fft", "ifft",
           "quadratic", "arange_like", "index_copy", "getnnz",
           "div_sqrt_dim", "sync_batch_norm"]


@register("_contrib_flash_attention", aliases=("flash_attention",))
def contrib_flash_attention(q, k, v, causal=False, scale=None):
    """Attention over (B, T, H, D) q, k, v (``causal`` masks the future;
    ``scale`` defaults to ``1/sqrt(D)``)."""
    from .nn import attr_bool

    return flash_attention(q, k, v, attr_bool(causal),
                           None if scale is None else float(scale))


@register("_contrib_count_sketch")
def count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """Each column of ``data`` times its sign ``s``, summed into the
    output column ``h`` picks (reference: contrib/count_sketch.cc)."""
    N, D = data.shape
    idx = h.reshape(-1)[:D].to(torch.int32).long()
    sign = s.reshape(-1)[:D]
    out = torch.zeros((N, int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, data * sign)


def _wide(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@register("_contrib_fft")
def fft(data, compute_size=128):
    """The FFT over the last axis, real and imaginary parts interleaved
    (computed in complex64 for any input narrower than float64)."""
    c = torch.fft.fft(_wide(data), dim=-1)
    return torch.stack([c.real, c.imag], dim=-1).reshape(
        *data.shape[:-1], -1).to(data.dtype)


@register("_contrib_ifft")
def ifft(data, compute_size=128):
    """The inverse of ``_contrib_fft``'s layout, unnormalized (times the
    length, as the reference's cuFFT inverse)."""
    D = data.shape[-1] // 2
    c = _wide(data).reshape(*data.shape[:-1], D, 2)
    comp = torch.complex(c[..., 0], c[..., 1])
    return (torch.fft.ifft(comp, dim=-1).real * D).to(data.dtype)


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("_contrib_arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` in ``data``'s shape (or along ``axis``)."""
    n = data.numel() if axis is None else data.shape[int(axis)]
    out = start + step * torch.arange(n, dtype=torch.float32,
                                      device=data.device)
    if axis is None:
        out = out.reshape(data.shape)
    return out.to(data.dtype)


@register("_contrib_index_copy")
def index_copy(old, idx, new):
    """``old`` with its rows ``idx`` replaced by ``new``'s."""
    return old.index_copy(0, idx.to(torch.int32).long(), new)


@register("_contrib_getnnz", differentiable=False)
def getnnz(data, axis=None):
    """The non-zero count (over ``axis``), as float32."""
    nz = data != 0
    out = nz.sum() if axis is None else nz.sum(dim=int(axis))
    return out.to(torch.float32)


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """``data / sqrt(last dim)`` (reference: contrib/transformer-inl.h)."""
    return data / math.sqrt(data.shape[-1])


@register("_contrib_SyncBatchNorm",
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1)
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    output_mean_var=False, ndev=1, key="", axis_name=None,
                    _training=True):
    """Cross-device BatchNorm (reference: contrib/sync_batch_norm-inl.h):
    with ``axis_name`` the batch moments are the means over every rank of
    that mesh axis (var = E[x^2] - mean^2); ``ndev`` and ``key`` are
    accepted and unused."""
    from .nn import attr_bool, batch_norm

    if _training and not attr_bool(use_global_stats) and \
            axis_name is not None:
        from ..parallel.collectives import allreduce, axis_size

        red = tuple(i for i in range(data.ndim) if i != 1)
        xf = data.float()
        moments = torch.stack([xf.mean(dim=red), (xf * xf).mean(dim=red)])
        moments = allreduce(moments, axis_name) / axis_size(axis_name)
        mean, sq = moments[0], moments[1]
        var = sq - mean * mean
        shape = [1] * data.ndim
        shape[1] = data.shape[1]
        g = torch.ones_like(gamma) if attr_bool(fix_gamma) else gamma
        inv = torch.rsqrt(var + eps)
        out = (data - mean.reshape(shape).to(data.dtype)) \
            * (g * inv).reshape(shape).to(data.dtype) \
            + beta.reshape(shape).to(data.dtype)
        if output_mean_var:
            return out, mean, var
        return out
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=1,
                      _training=_training)
