"""Convolution, transposed convolution, pooling and padding Gluon layers
(PyTorch counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: Conv1D,
Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose, Conv3DTranspose, the
1-, 2- and 3-D max, average and global pools, ReflectionPad2D), with the
reference's parameter names and shapes, so parameter files load across
packages."""
from __future__ import annotations

from ...ops.nn import is_channels_last
from ..block import HybridBlock
from .basic_layers import _init_of

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, transpose=False,
                 output_padding=0, **kwargs):
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
        self._transpose = transpose
        self._output_padding = _tuple(output_padding, ndim)
        if transpose and self._channels_last:
            # the Deconvolution op is channels-first only (the reference
            # refuses these layers the same way)
            raise NotImplementedError(
                "channels-last layout is not supported for transpose "
                "convs; use NC* layout")
        if transpose:
            wshape = (in_channels, channels // groups) + self._kernel
        else:
            wshape = (channels, in_channels // groups if in_channels
                      else 0) + self._kernel
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
        if self._transpose:
            return (cin, self._channels // self._groups) + self._kernel
        return (self._channels, cin // self._groups) + self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        kw = dict(kernel=self._kernel, stride=self._strides,
                  dilate=self._dilation, pad=self._padding,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=bias is None)
        if self._transpose:
            kw["adj"] = self._output_padding
        elif self._channels_last:
            # parameters are stored OI<spatial> whatever the layout
            # (checkpoints swap freely between layouts); the op's
            # channels-last weight is O<spatial>I: a permuted view, no copy
            kw["layout"] = self._layout
            weight = F.transpose(
                weight, axes=(0,) + tuple(range(2, 2 + self._ndim)) + (1,))
        op = F.Deconvolution if self._transpose else F.Convolution
        out = op(x, weight, *([bias] if bias is not None else []), **kw)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._channels}, "
                f"kernel_size={self._kernel}, stride={self._strides})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         transpose=True, output_padding=output_padding,
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


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "avg",
                         count_include_pad=count_include_pad, layout=layout,
                         **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg",
                         layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad=count_include_pad, layout=layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "avg",
                         count_include_pad=count_include_pad, layout=layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of NCHW data (an int pads
    all four sides)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
