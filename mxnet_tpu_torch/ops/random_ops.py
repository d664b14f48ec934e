"""Random sampling ops (PyTorch counterpart of
``mxnet_tpu/ops/random_ops.py``).

Each op takes its key as ``rng_key``: an int64 tensor of two uint32 words
on the output's device (the op wrappers draw it from the stream,
``mxnet_tpu_torch.random``).  The draws are ``jax.random``'s under the
partitionable threefry layout, in integer torch ops, so the bits are the
reference's: ``uniform`` sets the mantissa of ``1.0`` from the top 23 of
``w0 ^ w1`` (``(w0, w1) = threefry2x32(key, (0, flat index))``), ``normal``
is ``sqrt(2) * erfinv`` of a uniform on ``(-1, 1)``, ``exponential`` is
``-log1p(-u)`` and ``randint`` draws twice (the key's two halves) and
reduces modulo the span.  ``uniform``/``randint``/Dropout masks are bit
for bit the reference's; ``erfinv`` and ``log1p`` round as torch's do
(within a few ulps of XLA's).

The samplers that need a rejection loop or a sort (gamma, Poisson, the
negative binomials, multinomial, shuffle, unique zipfian) raise
``MXNetError``: ROADMAP Queue 1, item 2.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import register
from .sampling import threefry2x32

__all__ = ["uniform_bits", "uniform01", "bernoulli_mask"]

_M32 = 0xFFFFFFFF


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _const(v, device):
    """A float32 scalar made on ``device`` (a fill, no host copy: legal
    inside a CUDA-graph capture)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _check_key(rng_key):
    if not isinstance(rng_key, torch.Tensor) or rng_key.dtype != \
            torch.int64 or tuple(rng_key.shape) != (2,):
        raise MXNetError("a random op takes its key as an int64 tensor of "
                         "two uint32 words")


def uniform_bits(rng_key: torch.Tensor, shape) -> torch.Tensor:
    """``random_bits(key, 32, shape)``: ``w0 ^ w1`` of
    ``threefry2x32(key, (hi, lo) of the flat index)``, as int64."""
    _check_key(rng_key)
    shape = _shape(shape)
    idx = torch.arange(_numel(shape), dtype=torch.int64,
                       device=rng_key.device)
    b0, b1 = threefry2x32(rng_key[0], rng_key[1], idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform01(rng_key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    bits = (uniform_bits(rng_key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _uniform(rng_key, shape, low, high):
    """``floats * (high - low) + low`` as one fused multiply-add (XLA
    contracts it), emulated in float64: the f32 product is exact there."""
    lo = _const(low, rng_key.device)
    hi = _const(high, rng_key.device)
    f = uniform01(rng_key, shape)
    if low == 0.0 and high == 1.0:
        return f
    fma = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def bernoulli_mask(rng_key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (p as
    float32)."""
    return uniform01(rng_key, shape) < _const(p, rng_key.device)


def _float_dtype(dtype, what):
    if torch_dtype(dtype) != torch.float32:
        raise MXNetError(f"{what}: dtype {dtype!r} is not ported (float32; "
                         f"ROADMAP.md Queue 1, item 2)")
    return torch.float32


@register("_random_uniform", rng=True, differentiable=False,
          aliases=("uniform",))
def random_uniform(rng_key=None, low=0.0, high=1.0, shape=None,
                   dtype="float32"):
    _float_dtype(dtype, "_random_uniform")
    return _uniform(rng_key, _shape(shape), float(low), float(high))


@register("_random_normal", rng=True, differentiable=False,
          aliases=("normal",))
def random_normal(rng_key=None, loc=0.0, scale=1.0, shape=None,
                  dtype="float32"):
    _float_dtype(dtype, "_random_normal")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = _uniform(rng_key, _shape(shape), lo, 1.0)
    z = torch.erfinv(u) * _const(math.sqrt(2), u.device)
    return loc + scale * z


@register("_random_exponential", rng=True, differentiable=False)
def random_exponential(rng_key=None, lam=1.0, shape=None, dtype="float32"):
    _float_dtype(dtype, "_random_exponential")
    u = uniform01(rng_key, _shape(shape))
    return -torch.log1p(-u) / lam


@register("_random_randint", rng=True, differentiable=False)
def random_randint(rng_key=None, low=0, high=1, shape=None, dtype="int32"):
    """``jax.random.randint`` for int32: two 32-bit draws from the key's
    split, ``(hi % span * (2**32 % span) + lo % span) % span`` in uint32
    arithmetic, plus ``low``."""
    if torch_dtype(dtype) != torch.int32:
        raise MXNetError(f"_random_randint: dtype {dtype!r} is not ported "
                         f"(int32; ROADMAP.md Queue 1, item 2)")
    _check_key(rng_key)
    shape = _shape(shape)
    imax = 2 ** 31 - 1
    low_c = max(min(int(low), imax), -2 ** 31)
    high_c = max(min(int(high), imax), -2 ** 31)
    span = (high_c - low_c) & _M32
    if high_c <= low_c:
        span = 1
    elif int(high) > imax:
        span = (span + 1) & _M32
    idx = torch.arange(2, dtype=torch.int64, device=rng_key.device)
    k0, k1 = threefry2x32(rng_key[0], rng_key[1], torch.zeros_like(idx),
                          idx)
    higher = uniform_bits(torch.stack([k0[0], k1[0]]), shape)
    lower = uniform_bits(torch.stack([k0[1], k1[1]]), shape)
    if span == 0:   # the full 2**32 range: the remainders leave the bits
        offset = (higher * 0 + lower) & _M32
    else:
        mult = (((2 ** 16 % span) ** 2) & _M32) % span   # uint32 wrap
        offset = (((higher % span) * mult) & _M32) + lower % span
        offset = (offset & _M32) % span
    out = (offset + low_c) & _M32
    return torch.where(out > imax, out - 2 ** 32, out).to(torch.int32)


def _refused(name):
    def op(*args, **kwargs):
        raise MXNetError(f"{name} needs a rejection loop or a sort and is "
                         f"not ported (ROADMAP.md Queue 1, item 2)")
    op.__name__ = name
    op.__doc__ = f"{name}: not ported (ROADMAP.md Queue 1, item 2)."
    return op


for _name, _aliases in (("_random_gamma", ("gamma_sample",)),
                        ("_random_poisson", ()),
                        ("_random_negative_binomial", ()),
                        ("_random_generalized_negative_binomial", ()),
                        ("_sample_multinomial", ("multinomial",)),
                        ("shuffle", ("_shuffle",)),
                        ("_sample_unique_zipfian", ())):
    register(_name, rng=True, differentiable=False,
             aliases=_aliases)(_refused(_name))
del _name, _aliases
