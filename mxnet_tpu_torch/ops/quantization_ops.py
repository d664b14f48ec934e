"""Quantization ops (PyTorch counterpart of
``mxnet_tpu/ops/quantization_ops.py``; reference:
src/operator/quantization/).

Two families, under the reference's names, none differentiable:

- the reference's ``_contrib_*`` ops (``quantize``, ``quantize_v2``,
  ``dequantize``, ``requantize``, ``quantized_fully_connected``,
  ``quantized_conv``, ``quantized_pooling``, ``quantized_flatten``): int8
  tensors with their float ranges riding along, the matmul and
  convolution returning **int32 accumulators**;
- the serving family ``_tpumx_*`` that ``quantization.convert_symbol``
  inserts: symmetric int8 with an explicit scale tensor, int8 weights with
  per-output-channel scales, f32 results.

Integer products.  Torch has no integer convolution on CUDA, and an int8
``F.conv2d`` on the CPU returns int8 (it wraps).  Every quantized matmul
and convolution here is one exact integer GEMM, :func:`int8_matmul`:
``torch._int_mm`` (int8 x int8 -> int32, the int8 tensor cores on the
card), with the operands zero-padded to its shape rules (rows to at least
17, the shared dimension and the columns to multiples of 8: zeros add
nothing to a sum).  A convolution is that GEMM over an int8 im2col of its
input (``Tensor.unfold`` windows, any stride, padding, dilation, groups and
either layout), so the activations are copied once, in int8.  Operands
that are not both int8 (``uint8`` data from ``_contrib_quantize``, the
shape solver's float meta tensors) take the same product in float64,
which is exact for integer sums below 2**53.  Both routes give the exact
int32 sums, on the CPU and on the card alike, so the ``_contrib_*``
accumulators equal the reference's bit for bit; the ``_tpumx_*`` ops
convert the exact sum to f32 (the reference sums in f32, in its own
order: within rtol 1e-5).  No weight is widened: the only weight copy is
the padding of a shape off the rules (ResNet-50's first convolution,
``k = 147``: 64 x 152 bytes a forward).

f32 arithmetic follows the reference's: its Python constants are f32
(weak types), and a division by a scalar is a division by a tensor on the
operand's device (:func:`_div`) -- CUDA turns a division by a host scalar
into a multiplication by its reciprocal, which can move an int8 value.
Rounding is ``torch.round``: half to even, as ``jnp.round``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import _conv_args, is_channels_last, pooling
from .registry import register

__all__ = ["int8_matmul", "quantize", "quantize_v2", "dequantize",
           "requantize", "quantized_fully_connected", "quantized_conv",
           "quantized_pooling", "quantized_flatten", "tpumx_quantize_int8",
           "tpumx_dequantize_int8", "tpumx_quantized_fc_int8",
           "tpumx_quantized_conv_int8"]

_I32_MAX = float(2 ** 31 - 1)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d f32 tensor on ``like``'s device (a fill on the
    device: no host-to-device copy, which would wait for the stream)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as an f32 division on ``a``'s device (``b`` a number or a
    tensor)."""
    if not isinstance(b, torch.Tensor):
        b = _f32(b, a)
    return torch.div(a, b)


def _absmax(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.maximum(torch.abs(torch.min(lo)), torch.abs(torch.max(hi)))


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact integer product ``a @ w.T`` as int32, for ``a`` (m, k)
    and ``w`` (n, k) (module doc: ``torch._int_mm`` for two int8 operands,
    float64 otherwise)."""
    m, k = a.shape
    n = w.shape[0]
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        a64 = a.to(torch.int32).to(torch.float64)
        w64 = w.to(torch.int32).to(torch.float64)
        return torch.matmul(a64, w64.t()).to(torch.int32)
    kp, np_, mp = -(-k // 8) * 8, -(-n // 8) * 8, max(m, 17)
    if kp != k:
        a, w = F.pad(a, (0, kp - k)), F.pad(w, (0, kp - k))
    if np_ != n:
        w = F.pad(w, (0, 0, 0, np_ - n))
    if mp != m:
        a = F.pad(a, (0, 0, 0, mp - m))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n]


def _int_conv(data, weight, kernel, stride, dilate, pad, num_group,
              layout) -> torch.Tensor:
    """The exact integer convolution as int32, in ``data``'s layout (an
    im2col of ``data`` and :func:`int8_matmul` per group)."""
    nd = data.ndim - 2
    cl = is_channels_last(layout)
    stride, pad, dilate = _conv_args(nd, kernel, stride, dilate, pad)
    kernel = tuple(weight.shape[1:1 + nd]) if cl else tuple(weight.shape[2:])
    x = data.movedim(-1, 1) if cl else data          # (B, C, *spatial)
    B, C = x.shape[:2]
    if any(pad):
        x = F.pad(x, [p for pp in reversed(pad) for p in (pp, pp)])
    for i in range(nd):
        x = x.unfold(2 + i, (kernel[i] - 1) * dilate[i] + 1, stride[i])
    if any(d > 1 for d in dilate):
        x = x[(Ellipsis,) + tuple(slice(None, None, d) for d in dilate)]
    out_sp = tuple(x.shape[2:2 + nd])                # x: (B, C, *out, *k)
    rows = B * math.prod(out_sp)
    win = tuple(range(2 + nd, 2 + 2 * nd))
    sp = tuple(range(2, 2 + nd))
    # column order of the weight's own reshape: (C, *k) or (*k, C)
    perm = (0,) + sp + (win + (1,) if cl else (1,) + win)
    cols = x.permute(perm).reshape(rows, -1)
    O, G = weight.shape[0], int(num_group)
    w2 = weight.reshape(O, -1)
    if G == 1:
        acc = int8_matmul(cols, w2)
    else:
        kk = math.prod(kernel)
        cg = C // G
        if cl:
            cols = cols.reshape(rows, kk, G, cg).movedim(2, 1)
        cols = cols.reshape(rows, G, -1)
        wg = w2.reshape(G, O // G, -1)
        acc = torch.cat([int8_matmul(cols[:, g].contiguous(), wg[g])
                         for g in range(G)], dim=1)
    acc = acc.reshape((B,) + out_sp + (O,))
    return acc if cl else acc.movedim(-1, 1).contiguous()


def _split_bias(args, no_bias):
    if no_bias or len(args) == 6:
        data, weight, min_data, max_data, min_weight, max_weight = args
        return (data, weight, None, min_data, max_data, min_weight,
                max_weight, None, None)
    return tuple(args)


def _int_bias(acc, bias, min_bias, max_bias, out_scale, shape):
    """The int8 bias rescaled into the accumulator's scale and added."""
    sb = _absmax(min_bias, max_bias)
    b = torch.round(_div(bias.to(torch.float32) * _div(sb, 127.0),
                         out_scale))
    return acc + b.to(torch.int32).reshape(shape)


# ---------------------------------------------------------------------------
# the reference's _contrib_* family
# ---------------------------------------------------------------------------

@register("_contrib_quantize", num_outputs=3, differentiable=False)
def quantize(data, min_range, max_range, out_type="int8"):
    """float -> int8 (or uint8) over a calibration range (reference:
    quantize.cc); returns ``(q, min, max)``."""
    lo, hi = torch.min(min_range), torch.max(max_range)
    if out_type == "uint8":
        scale = _div(_f32(255.0, lo), torch.maximum(hi - lo, _f32(1e-8, lo)))
        q = torch.clamp(torch.round((data - lo) * scale), 0, 255) \
            .to(torch.uint8)
    else:
        t = torch.maximum(torch.abs(lo), torch.abs(hi))
        scale = _div(_f32(127.0, t), torch.maximum(t, _f32(1e-8, t)))
        q = torch.clamp(torch.round(data * scale), -127, 127) \
            .to(torch.int8)
    return q, lo.reshape(1), hi.reshape(1)


@register("_contrib_quantize_v2", num_outputs=3, differentiable=False)
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """``_contrib_quantize`` over the calibrated range when given, else
    over the data's own (reference: quantize_v2.cc)."""
    lo = _f32(min_calib_range, data) if min_calib_range is not None \
        else torch.min(data).to(torch.float32)
    hi = _f32(max_calib_range, data) if max_calib_range is not None \
        else torch.max(data).to(torch.float32)
    return quantize(data, lo, hi, out_type=out_type)


@register("_contrib_dequantize", differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8/uint8/int32 -> float32 (reference: dequantize.cc); an int32
    accumulator's range spans the whole int32 domain."""
    lo, hi = torch.min(min_range), torch.max(max_range)
    x = data.to(torch.float32)
    if data.dtype == torch.uint8:
        return x * _div(torch.maximum(hi - lo, _f32(1e-8, lo)), 255.0) + lo
    t = torch.maximum(torch.abs(lo), torch.abs(hi))
    return x * _div(t, _I32_MAX if data.dtype == torch.int32 else 127.0)


@register("_contrib_requantize", num_outputs=3, differentiable=False)
def requantize(data, min_range, max_range, out_type="int8",
               min_calib_range=None, max_calib_range=None):
    """int32 accumulator -> int8 (reference: requantize.cc), over the
    calibrated range when given, else the data's own."""
    real = data.to(torch.float32) * _div(_absmax(min_range, max_range),
                                         _I32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        t = _f32(max(abs(float(min_calib_range)),
                     abs(float(max_calib_range))), real)
    else:
        t = torch.maximum(torch.max(torch.abs(real)), _f32(1e-8, real))
    q = torch.clamp(torch.round(_div(real, t) * 127.0), -127, 127) \
        .to(torch.int8)
    return q, (-t).reshape(1), t.reshape(1)


@register("_contrib_quantized_fully_connected", num_outputs=3,
          differentiable=False)
def quantized_fully_connected(*args, num_hidden=0, no_bias=False,
                              flatten=True):
    """int8 FullyConnected with an exact int32 accumulator (reference:
    quantized_fully_connected.cc).  Inputs ``(data, weight, bias, min_data,
    max_data, min_weight, max_weight, min_bias, max_bias)``, the three
    bias entries absent under ``no_bias``; returns ``(acc, min, max)``."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = _split_bias(args, no_bias)
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]), weight)
    acc = acc.reshape(lead + (weight.shape[0],))
    out_scale = _div(_absmax(min_data, max_data), 127.0) * \
        _div(_absmax(min_weight, max_weight), 127.0)
    if bias is not None:
        acc = _int_bias(acc, bias, min_bias, max_bias, out_scale, (-1,))
    t = out_scale * _I32_MAX
    return acc, (-t).reshape(1), t.reshape(1)


@register("_contrib_quantized_conv", num_outputs=3, differentiable=False)
def quantized_conv(*args, kernel=(), stride=(), dilate=(), pad=(),
                   num_filter=0, num_group=1, no_bias=False, layout=None,
                   cudnn_tune=None, cudnn_off=False, workspace=1024):
    """int8 Convolution with an exact int32 accumulator (reference:
    quantized_conv.cu); inputs as ``_contrib_quantized_fully_connected``'s,
    returns ``(acc, min, max)``, the range the accumulator's real span."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = _split_bias(args, no_bias)
    acc = _int_conv(data, weight, kernel, stride, dilate, pad, num_group,
                    layout)
    out_scale = _div(_absmax(min_data, max_data), 127.0) * \
        _div(_absmax(min_weight, max_weight), 127.0)
    if bias is not None:
        nd = data.ndim - 2
        shape = (-1,) if is_channels_last(layout) else (1, -1) + (1,) * nd
        acc = _int_bias(acc, bias, min_bias, max_bias, out_scale, shape)
    t = out_scale * _I32_MAX
    return acc, (-t).reshape(1), t.reshape(1)


@register("_contrib_quantized_pooling", num_outputs=3, differentiable=False)
def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      stride=(), pad=(), global_pool=False, cudnn_off=False,
                      pooling_convention="valid", count_include_pad=True):
    """int8 Pooling (reference: quantized_pooling.cc): max stays exact,
    avg rounds back to int8; the range passes through."""
    out = pooling(data.to(torch.float32), kernel=kernel, pool_type=pool_type,
                  stride=stride, pad=pad, global_pool=global_pool,
                  pooling_convention=pooling_convention,
                  count_include_pad=count_include_pad)
    if data.dtype in (torch.int8, torch.uint8):
        out = torch.clamp(torch.round(out), -127, 127)
    return (out.to(data.dtype), torch.min(min_data).reshape(1),
            torch.max(max_data).reshape(1))


@register("_contrib_quantized_flatten", num_outputs=3, differentiable=False)
def quantized_flatten(data, min_data, max_data):
    """int8 Flatten (reference: quantized_flatten.cc)."""
    return (data.reshape(data.shape[0], -1), torch.min(min_data).reshape(1),
            torch.max(max_data).reshape(1))


# ---------------------------------------------------------------------------
# the serving family (quantization.convert_symbol's ops)
# ---------------------------------------------------------------------------

@register("_tpumx_quantize_int8", num_outputs=2, differentiable=False)
def tpumx_quantize_int8(data, scale=0.0):
    """float -> int8, ``clip(round(x / s), +-127)``: ``scale > 0`` is the
    calibrated static scale, otherwise the per-tensor absmax / 127 of this
    call's data; returns ``(q int8, s (1,))``."""
    x = data.to(torch.float32)
    if float(scale) > 0:
        s = _f32(scale, x)
    else:
        s = _div(torch.maximum(torch.amax(torch.abs(x)), _f32(1e-8, x)),
                 127.0)
    q = torch.clamp(torch.round(torch.div(x, s)), -127, 127).to(torch.int8)
    return q, s.reshape(1)


@register("_tpumx_dequantize_int8", differentiable=False)
def tpumx_dequantize_int8(data, scale, axis=-1):
    """int8 -> float32, ``q * s``: a (1,) ``scale`` per tensor, a longer
    one per channel along ``axis``."""
    x = data.to(torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.numel() > 1:
        ax = int(axis) % x.ndim
        s = s.reshape((1,) * ax + (-1,) + (1,) * (x.ndim - ax - 1))
    else:
        s = s.reshape(())
    return x * s


@register("_tpumx_quantized_fc_int8", differentiable=False)
def tpumx_quantized_fc_int8(*args, num_hidden=0, no_bias=False,
                            flatten=True):
    """int8 FullyConnected, f32 out: inputs ``(data_q, act_scale (1,),
    weight_q (out, in), w_scale (out,)[, bias (out,)])``; ``acc *
    (act_scale * w_scale) + bias``."""
    data_q, act_scale, weight_q, w_scale = args[:4]
    bias = None if (no_bias or len(args) < 5) else args[4]
    x = data_q
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]), weight_q)
    acc = acc.to(torch.float32).reshape(lead + (weight_q.shape[0],))
    out = acc * (act_scale.to(torch.float32).reshape(())
                 * w_scale.to(torch.float32))
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


@register("_tpumx_quantized_conv_int8", differentiable=False)
def tpumx_quantized_conv_int8(*args, kernel=(), stride=(), dilate=(),
                              pad=(), num_filter=0, num_group=1,
                              no_bias=False, layout=None, cudnn_tune=None,
                              cudnn_off=False, workspace=1024):
    """int8 Convolution, f32 out, per-output-channel weight scales; inputs
    as ``_tpumx_quantized_fc_int8``'s (weights in the reference's OIHW or,
    for a channels-last ``layout``, O<spatial>I layout)."""
    data_q, act_scale, weight_q, w_scale = args[:4]
    bias = None if (no_bias or len(args) < 5) else args[4]
    acc = _int_conv(data_q, weight_q, kernel, stride, dilate, pad,
                    num_group, layout).to(torch.float32)
    nd = data_q.ndim - 2
    cshape = ((1,) * (acc.ndim - 1) + (-1,) if is_channels_last(layout)
              else (1, -1) + (1,) * nd)
    out = acc * (act_scale.to(torch.float32).reshape(())
                 * w_scale.to(torch.float32).reshape(cshape))
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(cshape)
    return out
