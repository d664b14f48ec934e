"""Neural-net ops the model zoo, the Gluon layers and losses and the
symbolic API's loss heads need: FullyConnected, Convolution, Pooling
(valid and full conventions), BatchNorm, LayerNorm, InstanceNorm,
Activation, LeakyReLU, Dropout (a random op: it takes its key from the
stream), softmax, log_softmax, SoftmaxActivation, and the heads
SoftmaxOutput (alias Softmax), LinearRegressionOutput,
MAERegressionOutput, LogisticRegressionOutput and MakeLoss.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py`` (only these ops so far).
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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .batch_norm import bn_train_fused
from .layer_norm import layer_norm_fused
from .random_ops import bernoulli_mask
from .registry import register

__all__ = ["fully_connected", "is_channels_last", "convolution", "pooling",
           "batch_norm", "activation", "softmax", "log_softmax",
           "softmax_activation", "softmax_output", "make_loss", "attr_bool",
           "layer_norm", "instance_norm", "leaky_relu", "dropout"]


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
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"Pooling: pooling_convention "
                         f"{pooling_convention!r} is not ported (valid, "
                         f"full)")
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
    if pooling_convention == "full":
        # ceil mode as the reference computes it: the high side padded
        # until the ceil division is met, and an average still divided by
        # the whole window
        extra = []
        for i in range(2):
            size = x.shape[2 + i] + 2 * p[i]
            out_sz = -(-(size - k[i]) // s[i]) + 1
            extra.append(max(0, (out_sz - 1) * s[i] + k[i] - size))
        fill = float("-inf") if pool_type == "max" else 0.0
        pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])
        if pool_type == "max" or count_include_pad:
            xp = F.pad(x, pads, value=fill)
            out = F.max_pool2d(xp, k, s) if pool_type == "max" else \
                F.avg_pool2d(xp, k, s)
        else:
            ones = F.pad(torch.ones_like(x[:1, :1]), pads)
            out = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1) \
                / F.avg_pool2d(ones, k, s, divisor_override=1)
    elif pool_type == "max":
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
    plain torch ops."""
    ax = int(axis) % data.ndim
    if ax == data.ndim - 1 and not output_mean_var:
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
    return _SoftmaxOutputFn.apply(data, label, cfg)


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


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The identity: the head's gradient is the incoming cotangent (ones
    from the executor), as the reference's ``MakeLoss`` is."""
    return data
