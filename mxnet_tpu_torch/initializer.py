"""Weight initializers.

PyTorch counterpart of ``mxnet_tpu/initializer.py`` (``Initializer``,
``Uniform``, ``Normal``, ``Xavier``, ``Zero``, ``One``, ``Constant``,
``create``).  Same name-pattern dispatch as the reference: arrays whose
names end in ``bias``/``gamma``/``beta``/``running_*``/``moving_*`` get
their fixed defaults, everything else the configured weight initializer.

Random draws come from the ``torch.Generator`` the caller passes (the
global torch generator when none), so they match the reference's
distributions, not its bits; weights are carried across exactly by
``gluon.block.params_from_jax``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "Zero", "One",
           "Constant", "InitDesc", "register", "create"]

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

    def __call__(self, desc, arr, generator=None):
        """Initialize the tensor ``arr`` in place by its name ``desc``."""
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        self._gen = generator
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

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {tuple(shape)} "
                             f"for {desc}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _sample(arr, self._gen,
                    lambda t, g: t.uniform_(-scale, scale, generator=g))
        else:
            _sample(arr, self._gen,
                    lambda t, g: t.normal_(0.0, scale, generator=g))


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
