"""Neural-net ops the ResNet family and the Gluon losses need:
FullyConnected, Convolution, Pooling, BatchNorm, Activation, softmax and
log_softmax.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py`` (only these ops so far).
Layouts follow the reference: channels-first ``NCHW`` data with ``OIHW``
weights by default, and for ``layout="NHWC"`` the reference's
channels-last convention (``_conv_dnums``): NHWC data, OHWI weights.  A
channels-last convolution runs as ``F.conv2d`` on the NHWC tensor viewed as
NCHW in ``torch.channels_last`` memory, so the result viewed back as NHWC
is contiguous without a copy (cuDNN on the card; the reference likewise
leaves convolution to ``lax.conv_general_dilated``, outside any Pallas
kernel).

BatchNorm in training mode over channels-last data always goes through
:func:`ops.batch_norm.bn_train_fused` (the CUDA kernels on a CUDA tensor).
That function takes contiguous input only; a channels-last view that is
not contiguous (a transposed NCHW tensor, say) is copied first, as the
reference computes it too, and the copy is counted in
``batch_norm.noncontiguous_copies`` so that a layout slip on a hot path
shows.
The reference's ``MXTPU_BN_PALLAS`` gate and its ``C % 128`` and
``M % 8`` conditions are TPU lane and tiling rules and are not carried
over.  Channels-first training and inference-mode BatchNorm stay plain
torch ops, as the reference has no kernel for them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .batch_norm import bn_train_fused
from .registry import register

__all__ = ["fully_connected", "is_channels_last", "convolution", "pooling",
           "batch_norm", "activation", "softmax", "log_softmax"]


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


# ---------------------------------------------------------------------------
# FullyConnected (src/operator/nn/fully_connected.cc)
# ---------------------------------------------------------------------------

@register("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten and data.ndim > 2 \
        else data
    out = F.linear(x, weight)
    if not no_bias and bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Convolution (src/operator/nn/convolution.cc)
# ---------------------------------------------------------------------------

def is_channels_last(layout):
    """True for channels-last layout strings ("NHWC"/"NWC"/"NDHWC"); False
    for None or channels-first ("NC...")."""
    return bool(layout) and layout[1] != "C"


@register("Convolution")
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False, layout=None,
                cudnn_tune=None, cudnn_off=False, workspace=1024):
    """2-D convolution (reference: src/operator/nn/convolution.cc): NCHW
    data with OIHW weights, or NHWC data with OHWI weights for
    ``layout="NHWC"``.  cudnn_* / workspace attrs are accepted and
    ignored."""
    if data.ndim != 4:
        raise MXNetError(f"Convolution: only 2-D convolution is ported, got "
                         f"{data.ndim - 2}-D data")
    if layout not in (None, "NCHW", "NHWC"):
        raise MXNetError(f"Convolution: unsupported layout {layout!r}")
    k = len(kernel) if kernel else 2
    stride = _pair(stride, k) if stride else (1,) * k
    dilate = _pair(dilate, k) if dilate else (1,) * k
    pad = _pair(pad, k) if pad else (0,) * k
    b = None if no_bias else bias
    if layout == "NHWC":
        out = F.conv2d(data.permute(0, 3, 1, 2), weight.permute(0, 3, 1, 2),
                       b, stride, pad, dilate, int(num_group))
        return out.permute(0, 2, 3, 1)
    return F.conv2d(data, weight, b, stride, pad, dilate, int(num_group))


# ---------------------------------------------------------------------------
# Pooling (src/operator/nn/pooling.cc)
# ---------------------------------------------------------------------------

@register("Pooling")
def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", cudnn_off=False,
            count_include_pad=True, layout=None):
    """2-D max/avg pooling, global or windowed (``pooling_convention=
    "valid"``: floor division), channels-first or channels-last."""
    if data.ndim != 4:
        raise MXNetError(f"Pooling: only 2-D pooling is ported, got "
                         f"{data.ndim - 2}-D data")
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"Pooling: pool_type {pool_type!r} is not ported "
                         f"(max, avg)")
    channels_last = is_channels_last(layout)
    if global_pool:
        spatial = (1, 2) if channels_last else (2, 3)
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        return data.mean(dim=spatial, keepdim=True)
    if pooling_convention != "valid":
        raise MXNetError(f"Pooling: pooling_convention "
                         f"{pooling_convention!r} is not ported (valid)")
    k = _pair(kernel, 2)
    # reference PoolingParamParser defaults stride to 1 (pooling.cc:43-54)
    s = _pair(stride, 2) if stride else (1, 1)
    p = _pair(pad, 2) if pad else (0, 0)
    if any(v < 1 for v in s):
        raise MXNetError(f"Pooling stride must be >= 1, got {s}")
    sp0 = 1 if channels_last else 2
    for i in range(2):
        if k[i] > data.shape[sp0 + i] + 2 * p[i]:
            raise MXNetError(
                f"Pooling kernel {k} exceeds padded input "
                f"{tuple(data.shape[sp0:sp0 + 2])} (pad {p})")
    x = data.permute(0, 3, 1, 2) if channels_last else data
    if pool_type == "max":
        out = F.max_pool2d(x, k, s, p)
    else:
        out = F.avg_pool2d(x, k, s, p, count_include_pad=count_include_pad)
    return out.permute(0, 2, 3, 1) if channels_last else out


# ---------------------------------------------------------------------------
# BatchNorm (src/operator/nn/batch_norm.cc)
# ---------------------------------------------------------------------------

@register("BatchNorm",
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=True):
    """Reference: src/operator/nn/batch_norm.cc.  Functional: the running
    statistics are returned (``output_mean_var``) for the stateful Gluon
    layer to update, never mutated here."""
    ax = int(axis) % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _training and not use_global_stats:
        if ax == data.ndim - 1:
            if not data.is_contiguous():
                data = data.contiguous()
                batch_norm.noncontiguous_copies += 1
            out, mean, var = bn_train_fused(data, g, beta, float(eps))
            if output_mean_var:
                return out, mean, var
            return out
        # channels-first: one pass over the activation, recentred on a
        # per-channel pivot (one sampled position) against the E[x^2] -
        # mean^2 cancellation, as the reference's jnp path does
        red = tuple(i for i in range(data.ndim) if i != ax)
        xf = data.float()
        slicer = tuple(slice(None) if i == ax else 0
                       for i in range(data.ndim))
        pivot = xf[slicer].detach()
        shape = [1] * data.ndim
        shape[ax] = data.shape[ax]
        xc = xf - pivot.reshape(shape)
        mean_c = xc.mean(dim=red)
        var = ((xc * xc).mean(dim=red) - mean_c * mean_c).clamp_min(0.0)
        mean = mean_c + pivot
    else:
        mean, var = moving_mean, moving_var
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(shape).to(data.dtype)) \
        * (g * inv).reshape(shape).to(data.dtype) \
        + beta.reshape(shape).to(data.dtype)
    if output_mean_var:
        return out, mean, var
    return out


batch_norm.noncontiguous_copies = 0


# ---------------------------------------------------------------------------
# Activation (src/operator/nn/activation.cc)
# ---------------------------------------------------------------------------

@register("Activation")
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise ValueError(f"unknown act_type {act_type}")


# ---------------------------------------------------------------------------
# Softmax family (softmax.cc)
# ---------------------------------------------------------------------------

@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.softmax(x, dim=int(axis))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=int(axis))
