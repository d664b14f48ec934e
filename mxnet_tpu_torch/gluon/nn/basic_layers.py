"""Basic Gluon layers (PyTorch counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential, HybridSequential,
Dense, BatchNorm, Flatten)."""
from __future__ import annotations

from ... import autograd
from ... import initializer as init_mod
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "BatchNorm", "Flatten"]


def _init_of(spec):
    if spec is None or not isinstance(spec, str):
        return spec
    return init_mod.create(spec)


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers


class Dense(HybridBlock):
    """Fully-connected layer (reference: basic_layers.py Dense)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units) if in_units else (units, 0),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
                                            init=_init_of(bias_initializer),
                                            dtype=dtype)
            else:
                self.bias = None

    def _param_shape(self, param, args):
        x = args[0]
        in_units = 1
        if self._flatten:
            for d in x.shape[1:]:
                in_units *= d
        else:
            in_units = x.shape[-1]
        return (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics (reference:
    basic_layers.py BatchNorm).  In training mode (``autograd.is_training()``
    and not ``use_global_stats``) the op normalizes with the batch
    statistics and returns them; the layer then writes ``running = m *
    running + (1 - m) * batch`` in the running statistics' dtype."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        ch = in_channels if in_channels else 0
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=(ch,),
                init=_init_of(gamma_initializer), allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=(ch,),
                init=_init_of(beta_initializer), allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(ch,),
                init=_init_of(running_mean_initializer),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(ch,),
                init=_init_of(running_variance_initializer),
                allow_deferred_init=True, differentiable=False)

    def _param_shape(self, param, args):
        return (args[0].shape[self._axis],)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = F.BatchNorm(
                x, gamma, beta, running_mean, running_var,
                eps=self._epsilon, momentum=self._momentum,
                fix_gamma=not self._scale, use_global_stats=False,
                output_mean_var=True, axis=self._axis)
            m = self._momentum
            self.running_mean._assign(
                m * running_mean + (1 - m) * mean.detach().to(
                    running_mean.dtype))
            self.running_var._assign(
                m * running_var + (1 - m) * var.detach().to(
                    running_var.dtype))
            return out
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale, use_global_stats=True,
                           output_mean_var=False, axis=self._axis)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)
