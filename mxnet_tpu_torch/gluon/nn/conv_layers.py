"""2-D convolution and pooling Gluon layers (PyTorch counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``: Conv2D, MaxPool2D, GlobalAvgPool2D;
the other pooling layers, other dimensionalities and transposed
convolutions come later)."""
from __future__ import annotations

from ...ops.nn import is_channels_last
from ..block import HybridBlock
from .basic_layers import _init_of

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._ndim = ndim
        wshape = (channels, in_channels // groups) + self._kernel \
            if in_channels else (channels, 0) + self._kernel
        with self.name_scope():
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=_init_of(bias_initializer))
            else:
                self.bias = None

    @property
    def _channels_last(self):
        return is_channels_last(self._layout)

    def _param_shape(self, param, args):
        cin = args[0].shape[-1 if self._channels_last else 1]
        return (self._channels, cin // self._groups) + self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        kw = dict(kernel=self._kernel, stride=self._strides,
                  dilate=self._dilation, pad=self._padding,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=bias is None)
        if self._channels_last:
            # parameters are stored OIHW whatever the layout (checkpoints
            # swap freely between layouts); the op's channels-last weight
            # is OHWI: a permuted view, no copy
            kw["layout"] = self._layout
            weight = F.transpose(
                weight, axes=(0,) + tuple(range(2, 2 + self._ndim)) + (1,))
        out = F.Convolution(x, weight, bias, **kw)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if layout is not None:
            self._kwargs["layout"] = layout
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)
