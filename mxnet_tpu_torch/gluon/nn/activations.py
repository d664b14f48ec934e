"""Activation blocks (PyTorch counterpart of
``mxnet_tpu/gluon/nn/activations.py``)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod

        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
