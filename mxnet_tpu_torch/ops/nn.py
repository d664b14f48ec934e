"""Neural-net ops: FullyConnected, Convolution and Deconvolution (1-, 2-
and 3-D), Pooling (max, avg, sum; 1-, 2- and 3-D), the adaptive average
pooling and bilinear resize, UpSampling, BatchNorm, LayerNorm,
InstanceNorm, LRN, Activation, LeakyReLU, Dropout (a random op: it takes
its key from the stream), softmax, log_softmax, softmin,
SoftmaxActivation, softmax_cross_entropy, and the heads SoftmaxOutput
(alias Softmax), LinearRegressionOutput, MAERegressionOutput,
LogisticRegressionOutput and MakeLoss; the ``*_v1`` names are the same
ops.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py``, every op of it.
A head's backward is its own (a ``torch.autograd.Function``): the
reference's custom vjp, which ignores the incoming cotangent unless
``out_grad``.
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

Inside :func:`batch_norm_sync` (the mesh ``DataParallelTrainer``'s plain
step) a training BatchNorm normalizes with the statistics of the whole
data-parallel batch, as the reference's one program over the global
batch does: ``bn_train_fused`` with the given gather, each rank's
statistics from the kernels combined over the ranks.  Channels-first
data goes there too, moved to channels-last.  The op is reached through
the user's block, where no argument of the step can go, so the scope
carries the gather.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .batch_norm import bn_train_fused
from .layer_norm import layer_norm_fused, layer_norm_reference
from .random_ops import bernoulli_mask
from .registry import alias, register
from .tensor import relu

__all__ = ["fully_connected", "is_channels_last", "convolution",
           "deconvolution", "pooling",
           "batch_norm", "activation", "softmax", "log_softmax",
           "softmax_activation", "softmax_output", "make_loss", "attr_bool",
           "layer_norm", "instance_norm", "leaky_relu", "dropout",
           "batch_norm_sync"]


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
# Convolution / Deconvolution (convolution.cc, deconvolution.cc)
# ---------------------------------------------------------------------------

def is_channels_last(layout):
    """True for channels-last layout strings ("NHWC"/"NWC"/"NDHWC"); False
    for None or channels-first ("NC...")."""
    return bool(layout) and layout[1] != "C"


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _spatial(data, layout, what):
    nd = data.ndim - 2
    if nd not in _CONV:
        raise MXNetError(f"{what}: {nd}-D data (1-D, 2-D or 3-D)")
    if layout not in (None,) + _LAYOUTS[nd]:
        raise MXNetError(f"{what}: unsupported layout {layout!r} for "
                         f"{nd}-D data")
    return nd


def _conv_args(nd, kernel, stride, dilate, pad):
    k = len(kernel) if kernel else nd
    return (_pair(stride, k) if stride else (1,) * k,
            _pair(pad, k) if pad else (0,) * k,
            _pair(dilate, k) if dilate else (1,) * k)


@register("Convolution")
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False, layout=None,
                cudnn_tune=None, cudnn_off=False, workspace=1024):
    """1-, 2- or 3-D convolution (reference: src/operator/nn/
    convolution.cc): channels-first data with ``(O, I, *k)`` weights, or
    for a channels-last ``layout`` (``NWC``, ``NHWC``, ``NDHWC``)
    channels-last data with ``(O, *k, I)`` weights.  float16 computes in
    float32, as the reference does.  cudnn_* / workspace attrs are
    accepted and ignored."""
    nd = _spatial(data, layout, "Convolution")
    stride, pad, dilate = _conv_args(nd, kernel, stride, dilate, pad)
    b = None if no_bias else bias
    in_dtype = data.dtype
    if in_dtype == torch.float16:
        data, weight = data.float(), weight.float()
        b = None if b is None else b.float()
    conv = _CONV[nd]
    if is_channels_last(layout):
        out = conv(data.movedim(-1, 1), weight.movedim(-1, 1), b, stride,
                   pad, dilate, int(num_group)).movedim(1, -1)
    else:
        out = conv(data, weight, b, stride, pad, dilate, int(num_group))
    return out.to(in_dtype)


def _deconv_pads(data, weight, nd, stride, pad, dilate, adj, target_shape):
    """``(pad, adj)``; a ``target_shape`` sets both as MXNet's
    ``DeconvolutionParam::InferPad`` does: the total padding that gives
    that output size, split with its odd unit in ``adj``."""
    if not target_shape or not any(int(t) for t in target_shape):
        return pad, adj
    pads, adjs = [], []
    for i in range(nd):
        eff_k = (weight.shape[2 + i] - 1) * dilate[i] + 1
        total = stride[i] * (data.shape[2 + i] - 1) + eff_k \
            - int(target_shape[i])
        adjs.append(total % 2)
        pads.append((total + 1) // 2)
    return tuple(pads), tuple(adjs)


@register("Deconvolution")
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=False,
                  layout=None, target_shape=None, cudnn_tune=None,
                  cudnn_off=False, workspace=1024):
    """Transposed convolution (reference: src/operator/nn/
    deconvolution.cc): channels-first data, weights ``(in, out/group,
    *k)``, output ``(in - 1) * stride - 2 * pad + dilated kernel + adj``.
    Half-precision input computes in float32 and is cast back, as the
    reference does.  A ``target_shape`` sets ``pad`` and ``adj`` (MXNet's
    rule; the reference ignores it)."""
    if is_channels_last(layout):
        raise MXNetError("Deconvolution: channels-last layout is not "
                         "supported (the reference refuses it too); use NC*")
    nd = _spatial(data, layout, "Deconvolution")
    stride, pad, dilate = _conv_args(nd, kernel, stride, dilate, pad)
    adj = _pair(adj, nd) if adj else (0,) * nd
    pad, adj = _deconv_pads(data, weight, nd, stride, pad, dilate, adj,
                            target_shape)
    in_dtype = data.dtype
    if in_dtype in (torch.float16, torch.bfloat16):
        data, weight = data.float(), weight.float()
    out = _DECONV[nd](data, weight, None, stride, pad, adj, int(num_group),
                      dilate).to(in_dtype)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# Pooling (src/operator/nn/pooling.cc)
# ---------------------------------------------------------------------------

def _pool_nd(x, k, s, pads, pool_type, count_include_pad):
    """Channels-first pooling of ``x`` with explicit ``(lo, hi)`` pads
    per spatial dim: max pads with -inf, avg and sum with zeros; avg
    divides by the whole window, or with ``count_include_pad=False`` by
    the window's count of real entries.  1-D runs as 2-D over a trailing
    axis of one."""
    nd = len(k)
    if nd == 1:
        out = _pool_nd(x.unsqueeze(-1), k + (1,), s + (1,),
                       list(pads) + [(0, 0)], pool_type, count_include_pad)
        return out.squeeze(-1)
    if pool_type != "sum" and all(lo == hi and 2 * lo <= kk
                                  for (lo, hi), kk in zip(pads, k)):
        # symmetric pads within half the window: torch's own padding
        # computes the same (-inf for max, zeros or no count for avg)
        p = tuple(lo for lo, _ in pads)
        if pool_type == "max":
            return (F.max_pool2d if nd == 2 else F.max_pool3d)(x, k, s, p)
        return (F.avg_pool2d if nd == 2 else F.avg_pool3d)(
            x, k, s, p, count_include_pad=bool(count_include_pad))
    flat = [v for pr in reversed(pads) for v in pr]
    if pool_type == "max":
        xp = F.pad(x, flat, value=float("-inf")) if any(flat) else x
        return (F.max_pool2d if nd == 2 else F.max_pool3d)(xp, k, s)
    avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
    xp = F.pad(x, flat) if any(flat) else x
    if pool_type == "avg" and count_include_pad:
        return avg(xp, k, s)
    summed = avg(xp, k, s, divisor_override=1)
    if pool_type == "sum":
        return summed
    ones = F.pad(torch.ones_like(x[:1, :1]), flat)
    return summed / avg(ones, k, s, divisor_override=1)


@register("Pooling")
def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", cudnn_off=False,
            count_include_pad=True, layout=None):
    """Max, avg or sum pooling over the spatial dims of 1-, 2- or 3-D
    data, channels-first or channels-last; global, or windowed with the
    ``"full"`` convention (ceil division: the high side padded further)
    or any other (``"valid"``, ``"same"``: floor division), as the
    reference reads them.  Data of no spatial dim (a 2-D array, the
    default kernel ``()``) pools windows of one entry: itself."""
    nd = data.ndim - 2
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unsupported pool_type {pool_type}")
    channels_last = is_channels_last(layout)
    sp0 = 1 if channels_last else 2
    spatial = tuple(range(sp0, sp0 + nd))
    if global_pool:
        if not spatial:
            return data.clone()
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        return data.mean(dim=spatial, keepdim=True)
    k = _pair(kernel, nd)
    # reference PoolingParamParser defaults stride to 1 (pooling.cc:43-54)
    s = _pair(stride, nd) if stride else (1,) * nd
    p = _pair(pad, nd) if pad else (0,) * nd
    if any(v < 1 for v in s):
        raise MXNetError(f"Pooling stride must be >= 1, got {s}")
    for i in range(nd):
        if k[i] > data.shape[sp0 + i] + 2 * p[i]:
            raise MXNetError(
                f"Pooling kernel {k} exceeds padded input "
                f"{tuple(data.shape[sp0:sp0 + nd])} (pad {p})")
    if nd == 0:
        return data.clone() if pool_type != "avg" else data / 1.0
    pads = []
    for i in range(nd):
        extra = 0
        if pooling_convention == "full":
            size = data.shape[sp0 + i] + 2 * p[i]
            out_sz = -(-(size - k[i]) // s[i]) + 1
            extra = max(0, (out_sz - 1) * s[i] + k[i] - size)
        pads.append((p[i], p[i] + extra))
    x = data.movedim(-1, 1) if channels_last else data
    out = _pool_nd(x, k, s, pads, pool_type, count_include_pad)
    return out.movedim(1, -1) if channels_last else out


@register("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pooling(data, output_size=(1, 1)):
    """Mean over equal blocks when the output size divides the input's;
    otherwise the reference's linear resize (``jax.image.resize``,
    antialiased)."""
    oh, ow = _pair(output_size, 2)
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize_linear(data, oh, ow)


def _resize_linear(data, height, width):
    """``jax.image.resize(method="linear")``: a triangle filter at half-
    pixel centres, widened when shrinking (antialias), its weights
    renormalized at the border."""
    out = F.interpolate(data.float(), size=(int(height), int(width)),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.to(data.dtype) if data.dtype.is_floating_point else out


# ---------------------------------------------------------------------------
# BatchNorm (src/operator/nn/batch_norm.cc)
# ---------------------------------------------------------------------------

_bn_sync = threading.local()


@contextlib.contextmanager
def batch_norm_sync(sync):
    """Training BatchNorm inside takes its statistics over every rank's
    batch: ``sync(t)``, differentiable, stacks every rank's ``t`` on a new
    dim 0 (``ops.batch_norm.bn_train_fused``)."""
    prev = getattr(_bn_sync, "sync", None)
    _bn_sync.sync = sync
    try:
        yield
    finally:
        _bn_sync.sync = prev


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
    sync = getattr(_bn_sync, "sync", None)
    if _training and not use_global_stats:
        if ax == data.ndim - 1 or sync is not None:
            x = data.movedim(ax, -1)
            if not x.is_contiguous():
                x = x.contiguous()
                if ax == data.ndim - 1:
                    batch_norm.noncontiguous_copies += 1
            out, mean, var = bn_train_fused(x, g, beta, float(eps), sync)
            out = out.movedim(-1, ax)
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
        return relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise ValueError(f"unknown act_type {act_type}")


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """Reference: src/operator/leaky_relu.cc (leaky, elu, selu, prelu,
    rrelu at its mean slope, and tanh-approximated gelu)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1))
    if act_type == "selu":
        a, lam = 1.6732632423543772, 1.0507009873554805
        return lam * torch.where(data >= 0, data, a * (torch.exp(data) - 1))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, mid * data)
    if act_type == "gelu":
        return F.gelu(data, approximate="tanh")
    raise ValueError(f"unknown act_type {act_type}")


@register("Dropout", rng=True)
def dropout(data, rng_key=None, p=0.5, mode="training", axes=(),
            _training=True):
    """Reference: src/operator/nn/dropout.cc.  ``data * mask / keep`` in
    ``data``'s dtype, the mask ``uniform < keep`` from ``rng_key`` over
    ``data``'s shape with ``axes`` set to 1 (broadcast); identity outside
    training unless ``mode="always"``."""
    if not _training and mode != "always":
        return data
    p = float(p)
    if p <= 0.0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for ax in (axes or ()):
        shape[int(ax)] = 1
    mask = bernoulli_mask(rng_key, keep, tuple(shape)).to(data.dtype)
    return data * mask / keep


# ---------------------------------------------------------------------------
# LayerNorm / InstanceNorm (layer_norm.cc, instance_norm.cc)
# ---------------------------------------------------------------------------

@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalization over ``axis``.  Over the last axis (without
    ``output_mean_var``) it is :func:`ops.layer_norm.layer_norm_fused`
    (the CUDA kernel on a CUDA tensor, its plain version on a CPU one),
    as the reference takes ``layer_norm_fused`` there; other axes are
    plain torch ops.  The shape solver's meta tensors (no data) take the
    plain version's shapes."""
    ax = int(axis) % data.ndim
    if ax == data.ndim - 1 and not output_mean_var:
        if data.device.type == "meta":
            return layer_norm_reference(data, gamma, beta, float(eps))
        return layer_norm_fused(data.contiguous(), gamma, beta,
                                eps=float(eps))
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.ndim))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("LRN")
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (NCHW): ``x / (knorm
    + alpha / nsize * sum of x^2 over nsize channels) ** beta``
    (reference lrn-inl.h: ``salpha = alpha / nsize``)."""
    n = int(nsize)
    half = n // 2
    sq = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    win = sq.unfold(1, n, 1).sum(dim=-1)
    return data / torch.pow(knorm + (alpha / n) * win, beta)


# ---------------------------------------------------------------------------
# Softmax family (softmax.cc)
# ---------------------------------------------------------------------------

def _inexact(x):
    """Integer input of the softmax family computes in float32, as the
    reference's (``jax.nn.softmax`` on an integer array)."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    data = _inexact(data)
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.softmax(x, dim=int(axis))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    data = _inexact(data)
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=int(axis))


@register("softmin")
def softmin(data, axis=-1, temperature=None):
    return softmax(-data, axis=axis, temperature=temperature)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed cross entropy of ``softmax(data)`` rows against integer
    labels, a 0-d result."""
    logp = torch.log_softmax(_inexact(data), dim=-1)
    lab = label.to(torch.int32).long()
    return -torch.gather(logp, -1, lab[:, None]).sum()


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    data = _inexact(data)
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


# ---------------------------------------------------------------------------
# Loss heads (softmax_output.cc, regression_output.cc, make_loss.cc)
# ---------------------------------------------------------------------------

def attr_bool(v, default=False):
    """A boolean attribute that may arrive as a string ("False", "0",
    "true": graph JSON stringifies attributes)."""
    if v is None:
        return default
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes")
    return bool(v)


def _softmax_fwd_only(data, multi_output):
    if multi_output and data.ndim > 2:
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


def _one_hot(lab, nclass, dtype, axis=-1):
    """One-hot of integer ``lab`` (out-of-range rows, such as a -1
    ignore label, all zeros, as ``jax.nn.one_hot`` gives them)."""
    hit = lab.unsqueeze(-1) == torch.arange(nclass, device=lab.device)
    oh = hit.to(dtype)
    return oh.movedim(-1, axis) if axis != -1 else oh


def _so_bwd(out, label, g, grad_scale, ignore_label, multi_output,
            use_ignore, normalization, smooth_alpha, out_grad):
    """The head's gradient (reference ``_so_bwd``; softmax_output-inl.h):
    ``p - onehot`` masked, normalized and scaled, not the softmax's own
    vjp; the incoming cotangent ``g`` counts only with ``out_grad``."""
    if tuple(label.shape) == tuple(out.shape):
        # probability labels: scale * (p - label), no ignore/normalization
        grad = (out - label.to(out.dtype)) * grad_scale
        if out_grad:
            grad = grad * g.to(grad.dtype)
        return grad.to(out.dtype)
    lab = label.to(torch.int32).long()
    if multi_output and out.ndim > 2:
        nclass = out.shape[1]
        onehot = _one_hot(lab, nclass, out.dtype, axis=1)
        spatial = 1
        for d in out.shape[2:]:
            spatial *= d
    else:
        nclass = out.shape[-1]
        onehot = _one_hot(lab, nclass, out.dtype)
        if onehot.ndim < out.ndim:
            onehot = onehot.reshape(out.shape)
        spatial = 1
    if smooth_alpha:
        onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / nclass
    grad = out - onehot
    if use_ignore:
        mask = (label != ignore_label).to(out.dtype)
        if multi_output and out.ndim > 2:
            mask = mask.unsqueeze(1)
        else:
            mask = mask.reshape(mask.shape + (1,) * (grad.ndim - mask.ndim))
        grad = grad * mask
    # the denominator: N (x spatial) for "batch", the non-ignored label
    # count for "valid", spatial for "null"
    if normalization == "batch":
        denom = float(label.shape[0]) * spatial
    elif normalization == "valid":
        if use_ignore:
            denom = torch.clamp((label != ignore_label).sum(), min=1).to(
                out.dtype)
        else:
            denom = float(label.numel())
    else:
        denom = float(spatial)
    grad = grad * (grad_scale / denom)
    if out_grad:
        grad = grad * g.to(grad.dtype)
    return grad.to(out.dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        out = _softmax_fwd_only(data, cfg[2])
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        return _so_bwd(out, label, g, *ctx.cfg), None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax with the cross-entropy gradient as its backward (reference:
    src/operator/nn/softmax_output.cc): the forward gives probabilities,
    the backward ``p - onehot(label)`` with ``ignore_label`` masking, the
    ``normalization`` modes, ``smooth_alpha`` and ``grad_scale``,
    probability labels (``label.shape == data.shape``), and the incoming
    cotangent only with ``out_grad``."""
    cfg = (float(grad_scale), float(ignore_label), bool(multi_output),
           bool(use_ignore), str(normalization), float(smooth_alpha),
           attr_bool(out_grad))
    return _SoftmaxOutputFn.apply(_inexact(data), label, cfg)


class _RegressionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, kind, out_grad):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, kind, out_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind, out_grad = ctx.cfg
        lab = label.reshape(out.shape)
        grad = torch.sign(out - lab) if kind == "mae" else out - lab
        grad = grad * grad_scale
        if out_grad:
            grad = grad * g.to(grad.dtype)
        return grad, None, None, None, None


def _regression(kind):
    def head(data, label, grad_scale=1.0, out_grad=False):
        return _RegressionFn.apply(data, label, float(grad_scale), kind,
                                   attr_bool(out_grad))
    return head


register("LinearRegressionOutput")(_regression("linear"))
register("MAERegressionOutput")(_regression("mae"))
register("LogisticRegressionOutput")(_regression("logistic"))


@register("UpSampling")
def upsampling(data, *weights, scale=2, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=1, workspace=512):
    """NCHW upsampling by ``scale``: nearest repeats each pixel, bilinear
    is the reference's linear resize (its weight inputs are ignored, as
    the reference ignores them)."""
    s = int(scale)
    if sample_type == "nearest":
        return torch.repeat_interleave(torch.repeat_interleave(data, s, 2),
                                       s, 3)
    n, c, h, w = data.shape
    return _resize_linear(data, h * s, w * s)


@register("_contrib_BilinearResize2D")
def bilinear_resize(data, height=1, width=1, scale_height=None,
                    scale_width=None):
    n, c, h, w = data.shape
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return _resize_linear(data, int(height), int(width))


# the pre-NNVM names of three ops (reference: batch_norm_v1.cc,
# convolution_v1.cc, pooling_v1.cc): the same functions
alias("BatchNorm_v1", "BatchNorm")
alias("Convolution_v1", "Convolution")
alias("Pooling_v1", "Pooling")


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The identity: the head's gradient is the incoming cotangent (ones
    from the executor), as the reference's ``MakeLoss`` is."""
    return data
