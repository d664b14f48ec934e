"""Weight initializers.

PyTorch counterpart of ``mxnet_tpu/initializer.py``, every initializer of
it (``Uniform``, ``Normal``, ``Xavier``, ``Zero``, ``One``, ``Constant``,
``Orthogonal``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``,
``Mixed``, ``create``).  Same name-pattern dispatch as the reference:
arrays whose names end in ``bias``/``gamma``/``beta``/``running_*``/
``moving_*`` get their fixed defaults, everything else the configured
weight initializer.

``Uniform``, ``Normal`` and ``Xavier`` draw from the ``torch.Generator``
the caller passes (the global torch generator when none), so they match
the reference's distributions, not its bits; weights are carried across
exactly by ``gluon.block.params_from_jax``.  ``Orthogonal``,
``MSRAPrelu`` and ``FusedRNN`` draw, without a generator, from numpy's
global stream as the reference does, so that after the same
``np.random.seed`` they give the reference's bytes; ``Bilinear`` and
``LSTMBias`` are not random.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "Zero", "One",
           "Constant", "Orthogonal", "MSRAPrelu", "Bilinear", "LSTMBias",
           "FusedRNN", "Mixed", "InitDesc", "register", "create"]

_REG = {}


def register(*names):
    """Class decorator: make ``create(name)`` build the class."""
    def _reg(klass):
        for n in names or (klass.__name__.lower(),):
            _REG[n] = klass
        return klass
    return _reg


class InitDesc(str):
    """Array name + attrs hint (reference: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _sample(arr, generator, draw):
    """Fill ``arr`` in place with ``draw(t, generator)`` run on a tensor of
    the generator's device (the global generator: ``arr``'s own)."""
    dev = generator.device if generator is not None else arr.device
    with torch.no_grad():
        if dev == arr.device:
            draw(arr, generator)
        else:
            tmp = torch.empty(arr.shape, dtype=torch.float32, device=dev)
            draw(tmp, generator)
            arr.copy_(tmp)


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        """``[name, kwargs]`` as JSON: a symbol variable's ``__init__``
        attribute (``sym.Variable(init=...)``)."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        """Initialize the tensor ``arr`` in place by its name ``desc`` (an
        ``InitDesc`` whose ``__init__`` attribute names an initializer
        takes that one)."""
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        self._gen = generator
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            chosen = create(klass, **kwargs)
            chosen._gen = generator
            chosen._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, desc, arr):
        with torch.no_grad():
            arr.zero_()

    def _init_one(self, desc, arr):
        with torch.no_grad():
            arr.fill_(1.0)

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_gamma(self, desc, arr):
        self._init_one(desc, arr)

    def _init_beta(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register("uniform")
class Uniform(Initializer):
    """U(-scale, scale) (Gluon's default initializer, scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        _sample(arr, self._gen,
                lambda t, g: t.uniform_(-self.scale, self.scale, generator=g))


@register("normal")
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        _sample(arr, self._gen,
                lambda t, g: t.normal_(0.0, self.sigma, generator=g))


@register("zero", "zeros")
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


@register("one", "ones")
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        with torch.no_grad():
            arr.fill_(self.value)


@register("xavier")
class Xavier(Initializer):
    """Glorot: U(-s, s) or N(0, s^2), s = sqrt(magnitude / factor) with the
    factor the average, fan-in or fan-out of the (out, in, *kernel)
    shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _scale(self, desc, shape):
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {tuple(shape)} "
                             f"for {desc}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, desc, arr):
        scale = self._scale(desc, arr.shape)
        if self.rnd_type == "uniform":
            _sample(arr, self._gen,
                    lambda t, g: t.uniform_(-scale, scale, generator=g))
        else:
            _sample(arr, self._gen,
                    lambda t, g: t.normal_(0.0, scale, generator=g))


def _set(arr, value):
    """Copy the numpy ``value`` into ``arr`` (rounded to its dtype)."""
    with torch.no_grad():
        arr.copy_(torch.from_numpy(np.array(value, np.float32).reshape(
            tuple(arr.shape))))


def _draw(gen, shape, kind, a, b):
    """float64 draws of ``shape``: numpy's global stream without a
    generator (the reference's), else the generator's; ``kind`` uniform
    on [a, b) or normal of mean a, deviation b."""
    if gen is None:
        if kind == "uniform":
            return np.random.uniform(a, b, shape)
        return np.random.normal(a, b, shape)
    t = torch.empty(shape, dtype=torch.float64, device=gen.device)
    if kind == "uniform":
        t.uniform_(a, b, generator=gen)
    else:
        t.normal_(a, b, generator=gen)
    return t.cpu().numpy()


@register("orthogonal")
class Orthogonal(Initializer):
    """A (scaled) orthogonal matrix from the SVD of a random one, of the
    weight's shape flattened to (out, in)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _draw(self._gen, (nout, nin), "uniform", -1.0, 1.0)
        else:
            tmp = _draw(self._gen, (nout, nin), "normal", 0.0, 1.0)
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _set(arr, self.scale * q)


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialization for PReLU: Xavier's gaussian with magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}

    def _init_weight(self, desc, arr):
        if self._gen is not None:
            return super()._init_weight(desc, arr)
        _set(arr, np.random.normal(0, self._scale(desc, arr.shape),
                                   tuple(arr.shape)))


@register("bilinear")
class Bilinear(Initializer):
    """The bilinear upsampling filter in every (out, in) plane of a
    Deconvolution weight: ``(1 - |x/f - c|) (1 - |y/f - c|)`` with ``f =
    ceil(k/2)``, ``c = (2f - 1 - f % 2) / 2f``."""

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = np.arange(shape[3])[None, :]
        y = np.arange(shape[2])[:, None]
        plane = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        _set(arr, np.broadcast_to(plane.astype(np.float32), shape))


@register("lstmbias")
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (the second) at
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(tuple(arr.shape), dtype=np.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _set(arr, b)

    _init_bias = _init_weight
    _init_default = _init_weight


@register("fusedrnn")
class FusedRNN(Initializer):
    """A fused RNN parameter blob: U(-0.07, 0.07), as the reference draws
    it (its ``init`` is kept, not used)."""

    def __init__(self, init=None, num_hidden=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        super().__init__(num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode)
        self._init = init or Xavier()
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        _set(arr, _draw(self._gen, tuple(arr.shape), "uniform", -0.07,
                        0.07))

    _init_default = _init_weight


class Mixed:
    """The first initializer whose pattern matches the array's name
    (``re.match``) initializes it."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, desc, arr, generator=None):
        for pat, init in self.map:
            if pat.match(desc):
                init(desc, arr, generator)
                return
        raise ValueError(f"no initializer pattern matches {desc!r}")


def create(name, **kwargs) -> Initializer:
    """An initializer by name (``"uniform"``, ``"zeros"``, ...), or
    ``name`` itself when it already is one."""
    if isinstance(name, Initializer):
        return name
    try:
        return _REG[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown initializer {name!r}; known: "
                         f"{sorted(_REG)}") from None
