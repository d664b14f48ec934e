"""Contrib Gluon blocks (PyTorch counterpart of
``mxnet_tpu/gluon/contrib/nn.py``; reference:
``gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock
from ..nn import BatchNorm as _BatchNorm
from ..nn import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Runs its children on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable ``Concurrent``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Passes its input through."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """``Embedding`` whose weight declares ``grad_stype="row_sparse"``;
    the lookup is a gather and its gradient dense, as in the reference."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, grad_stype="row_sparse")

    def forward(self, x):
        return nd.Embedding(x, self.weight._tensor(), **self._kwargs)

    def __repr__(self):
        return (f"SparseEmbedding({self._kwargs['input_dim']} -> "
                f"{self._kwargs['output_dim']})")


class SyncBatchNorm(_BatchNorm):
    """Cross-device BatchNorm: the plain layer with the reference's
    constructor (``num_devices`` accepted and unused); a per-rank program
    calls the ``_contrib_SyncBatchNorm`` op with ``axis_name``."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
