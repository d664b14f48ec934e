"""``mx.nd.random`` (PyTorch counterpart of ``mxnet_tpu/ndarray/random.py``):
the samplers as NDArray functions, each one draw from the stream
(``mxnet_tpu_torch.random``), on ``ctx`` (default: the current context).
``gamma``, ``poisson``, the negative binomials, ``multinomial`` and
``shuffle`` raise ``MXNetError`` (ROADMAP.md Queue 1, item 2)."""
from __future__ import annotations

from ..ops.registry import get_op
from .ndarray import invoke

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "randn"]


def _shape(shape):
    if shape is None:
        return None
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _draw(opname, attrs, shape, ctx, out):
    attrs = dict(attrs, shape=_shape(shape) or (1,), ctx=ctx)
    return invoke(get_op(opname), [], attrs, out=out)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    return _draw("_random_uniform", {"low": low, "high": high,
                                     "dtype": dtype}, shape, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    return _draw("_random_normal", {"loc": loc, "scale": scale,
                                    "dtype": dtype}, shape, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _draw("_random_gamma", {"alpha": alpha, "beta": beta,
                                   "dtype": dtype}, shape, ctx, out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("_random_exponential", {"lam": 1.0 / scale,
                                         "dtype": dtype}, shape, ctx, out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("_random_poisson", {"lam": lam, "dtype": dtype}, shape,
                 ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _draw("_random_negative_binomial", {"k": k, "p": p,
                                               "dtype": dtype}, shape, ctx,
                 out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None):
    return _draw("_random_generalized_negative_binomial",
                 {"mu": mu, "alpha": alpha, "dtype": dtype}, shape, ctx, out)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _draw("_random_randint", {"low": low, "high": high,
                                     "dtype": dtype}, shape, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None):
    return invoke(get_op("_sample_multinomial"), [data],
                  {"shape": _shape(shape) or (), "get_prob": get_prob,
                   "dtype": dtype}, out=out)


def shuffle(data, out=None):
    return invoke(get_op("shuffle"), [data], {}, out=out)
