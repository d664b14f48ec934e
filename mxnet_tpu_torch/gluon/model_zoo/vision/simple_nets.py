"""Non-residual model-zoo families (PyTorch counterpart of
``mxnet_tpu/gluon/model_zoo/vision/simple_nets.py``): AlexNet, VGG (with
and without BatchNorm), SqueezeNet 1.0/1.1, MobileNet v1/v2, DenseNet and
Inception v3, with the reference's factory names, arguments and parameter
names, in both layouts.

Every architecture is a data table read by the shared combinators:
``_unit`` (conv, optional BatchNorm, optional activation), ``_chain``,
``_fanout`` (concatenated branches: SqueezeNet's fire, every Inception
cell), ``_SkipJoin`` and ``_WidenJoin`` (MobileNet v2's residual,
DenseNet's growth).  ``layout="NHWC"`` builds the channels-last variant,
whose BatchNorms train through the BatchNorm kernels; parameters stay
OIHW, so checkpoints swap between layouts.  The reference's recommended
mode is hybridized and cast to bfloat16 (``net.cast("bfloat16")``, SGD
with ``multi_precision``).
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .... import initializer as init
from ....ops.nn import is_channels_last

__all__ = ["AlexNet", "alexnet", "VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "MobileNet", "MobileNetV2",
           "get_mobilenet", "get_mobilenet_v2", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "Inception3", "inception_v3"]


# ---------------------------------------------------------------------------
# shared combinators
# ---------------------------------------------------------------------------

def _chain(*parts):
    out = nn.HybridSequential(prefix="")
    for part in parts:
        out.add(part)
    return out


def _relu6():
    return nn.HybridLambda(lambda F, x: F.clip(x, 0, 6))


def _unit(ch, k=1, s=1, p=0, groups=1, bias=False, norm=True, act="relu",
          eps=1e-5, weight_initializer=None, layout="NCHW"):
    """conv [+ BatchNorm] [+ activation] — the one conv builder here.

    ``act`` is "relu", "relu6", or None. Returns a HybridSequential so a
    unit can be dropped anywhere a block is expected.  ``layout="NHWC"``
    builds the channels-last variant (parameters stay OIHW, so checkpoints
    swap freely — same contract as the resnet zoo).
    """
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(ch, k, s, p, groups=groups, use_bias=bias,
                      weight_initializer=weight_initializer, layout=layout))
    if norm:
        # classify like Conv2D does (is_channels_last), not by exact string
        # compare — a non-canonical channels-last string would otherwise
        # normalize the H axis silently
        out.add(nn.BatchNorm(
            epsilon=eps, axis=-1 if is_channels_last(layout) else 1))
    if act == "relu":
        out.add(nn.Activation("relu"))
    elif act == "relu6":
        out.add(_relu6())
    return out


def _fanout(*branches, layout="NCHW"):
    out = nn.HybridConcatenate(axis=-1 if is_channels_last(layout) else 1)
    for branch in branches:
        out.add(branch)
    return out


class _SkipJoin(HybridBlock):
    """x + body(x) when ``joined``, else just body(x) (stride/width change)."""

    def __init__(self, body, joined, **kwargs):
        super().__init__(**kwargs)
        self.body = body
        self._joined = joined

    def hybrid_forward(self, F, x):
        y = self.body(x)
        return y + x if self._joined else y


class _WidenJoin(HybridBlock):
    """concat(x, body(x)) along channels — DenseNet's growth step."""

    def __init__(self, body, channel_dim=1, **kwargs):
        super().__init__(**kwargs)
        self.body = body
        self._cdim = channel_dim

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=self._cdim)


def _strip(kwargs):
    for unsupported in ("pretrained", "ctx", "root"):
        if kwargs.pop(unsupported, None):
            if unsupported == "pretrained":
                raise RuntimeError("pretrained weights unavailable "
                                   "(no egress)")
    return kwargs


def _head(classes):
    return nn.Dense(classes)


# ---------------------------------------------------------------------------
# AlexNet — a flat token list
# ---------------------------------------------------------------------------

# (channels, kernel, stride, pad) conv rows; "P" = 3x3/2 maxpool
_ALEX_TRUNK = [(64, 11, 4, 2), "P", (192, 5, 1, 2), "P",
               (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "P"]


def _to_nchw_order(layout):
    """Before Flatten->Dense: put channels back in NCHW order so the
    flattened feature order — and therefore the Dense weights — stay
    layout-independent (checkpoints swap freely).  The relayout happens at
    the final, smallest feature map; GlobalAvgPool-headed nets don't need
    it."""
    if not is_channels_last(layout):
        return None
    return nn.HybridLambda(lambda F, x: F.transpose(x, axes=(0, 3, 1, 2)))


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for row in _ALEX_TRUNK:
                if row == "P":
                    self.features.add(nn.MaxPool2D(3, 2, layout=layout))
                else:
                    ch, k, s, p = row
                    self.features.add(_unit(ch, k, s, p, bias=True,
                                            norm=False, layout=layout))
            relayout = _to_nchw_order(layout)
            if relayout is not None:
                self.features.add(relayout)
            self.features.add(nn.Flatten())
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = _head(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(**kwargs):
    return AlexNet(**_strip(kwargs))


# ---------------------------------------------------------------------------
# VGG — (repeats, width) rows
# ---------------------------------------------------------------------------

_VGG_ROWS = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
             16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
_VGG_WIDTHS = (64, 128, 256, 512, 512)


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("one filter width per VGG stage")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            # reference vgg.py: Xavier(gaussian, factor_type='out',
            # magnitude=2) on conv weights — from-scratch convergence
            # parity matters here because pretrained weights are
            # not downloaded
            conv_init = init.Xavier(rnd_type="gaussian",
                                    factor_type="out", magnitude=2)
            for reps, width in zip(layers, filters):
                for _ in range(reps):
                    self.features.add(_unit(width, 3, 1, 1, bias=True,
                                            norm=batch_norm,
                                            weight_initializer=conv_init,
                                            layout=layout))
                self.features.add(nn.MaxPool2D(strides=2, layout=layout))
            relayout = _to_nchw_order(layout)
            if relayout is not None:
                self.features.add(relayout)
            self.features.add(nn.Flatten())
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="normal"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _vgg_constructor(depth, batch_norm):
    def ctor(**kwargs):
        return VGG(list(_VGG_ROWS[depth]), list(_VGG_WIDTHS),
                   batch_norm=batch_norm, **_strip(kwargs))

    ctor.__name__ = ctor.__qualname__ = (f"vgg{depth}_bn" if batch_norm
                                         else f"vgg{depth}")
    ctor.__doc__ = (f"VGG-{depth}" + (" with BatchNorm" if batch_norm
                                      else ""))
    return ctor


def get_vgg(num_layers, batch_norm=False, **kwargs):
    """Parameterized VGG factory (reference vgg.py get_vgg)."""
    if num_layers not in _VGG_ROWS:
        raise ValueError(f"VGG depth must be one of {sorted(_VGG_ROWS)}")
    return VGG(list(_VGG_ROWS[num_layers]), list(_VGG_WIDTHS),
               batch_norm=batch_norm, **_strip(kwargs))


for _d in _VGG_ROWS:
    for _bn in (False, True):
        _f = _vgg_constructor(_d, _bn)
        globals()[_f.__name__] = _f
del _d, _bn, _f


# ---------------------------------------------------------------------------
# SqueezeNet — token lists of fire cells and pools
# ---------------------------------------------------------------------------

def _fire(squeeze, expand, layout="NCHW"):
    """1x1 squeeze feeding a (1x1 || 3x3) expand fanout."""
    return _chain(_unit(squeeze, 1, bias=True, norm=False, layout=layout),
                  _fanout(_unit(expand, 1, bias=True, norm=False,
                                layout=layout),
                          _unit(expand, 3, p=1, bias=True, norm=False,
                                layout=layout),
                          layout=layout))


# stem conv row then "P" pools / fire (squeeze, expand) rows
_SQUEEZE_PLANS = {
    "1.0": [(96, 7, 2), "P", (16, 64), (16, 64), (32, 128), "P",
            (32, 128), (48, 192), (48, 192), (64, 256), "P", (64, 256)],
    "1.1": [(64, 3, 2), "P", (16, 64), (16, 64), "P", (32, 128), (32, 128),
            "P", (48, 192), (48, 192), (64, 256), (64, 256)],
}


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if version not in _SQUEEZE_PLANS:
            raise ValueError(f"unknown SqueezeNet version {version!r}")
        plan = _SQUEEZE_PLANS[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            ch, k, s = plan[0]
            self.features.add(_unit(ch, k, s, bias=True, norm=False,
                                    layout=layout))
            for row in plan[1:]:
                if row == "P":
                    self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True,
                                                   layout=layout))
                else:
                    self.features.add(_fire(*row, layout=layout))
            self.features.add(nn.Dropout(0.5))
            # reference squeezenet.py: fixed AvgPool2D(13) head (identical
            # to global pooling at 224px, different — and reference-matching
            # — for other input sizes)
            self.output = _chain(_unit(classes, 1, bias=True, norm=False,
                                       layout=layout),
                                 nn.AvgPool2D(13, layout=layout),
                                 nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **_strip(kwargs))


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **_strip(kwargs))


# ---------------------------------------------------------------------------
# MobileNet v1 — (out_channels, stride) separable rows
# ---------------------------------------------------------------------------

_MOBILE_V1_ROWS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                   (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                   (512, 1), (1024, 2), (1024, 1)]


def _separable(width_in, width_out, stride, act="relu", layout="NCHW"):
    """Depthwise 3x3 over ``width_in`` then pointwise to ``width_out``."""
    return _chain(_unit(width_in, 3, stride, 1, groups=width_in, act=act,
                        layout=layout),
                  _unit(width_out, act=act, layout=layout))


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        scale = lambda c: int(c * multiplier)  # noqa: E731
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            width = scale(32)
            self.features.add(_unit(width, 3, 2, 1, layout=layout))
            for out, stride in _MOBILE_V1_ROWS:
                out = scale(out)
                self.features.add(_separable(width, out, stride,
                                             layout=layout))
                width = out
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = _head(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# ---------------------------------------------------------------------------
# MobileNet v2 — the paper's (expansion t, channels c, repeats n, stride s)
# ---------------------------------------------------------------------------

_MOBILE_V2_ROWS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                   (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                   (6, 320, 1, 1)]


def _inverted_residual(width_in, width_out, t, stride, layout="NCHW"):
    mid = width_in * t
    body = _chain(_unit(mid, act="relu6", layout=layout),
                  _unit(mid, 3, stride, 1, groups=mid, act="relu6",
                        layout=layout),
                  _unit(width_out, act=None, layout=layout))
    return _SkipJoin(body, joined=stride == 1 and width_in == width_out)


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        scale = lambda c: int(c * multiplier)  # noqa: E731
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            width = scale(32)
            self.features.add(_unit(width, 3, 2, 1, act="relu6",
                                    layout=layout))
            for t, c, n, s in _MOBILE_V2_ROWS:
                out = scale(c)
                for i in range(n):
                    self.features.add(_inverted_residual(
                        width, out, t, s if i == 0 else 1, layout=layout))
                    width = out
            tip = scale(1280) if multiplier > 1.0 else 1280
            self.features.add(_unit(tip, act="relu6", layout=layout))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = _chain(_unit(classes, 1, norm=False, act=None,
                                       layout=layout),
                                 nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _mobile_constructor(cls, multiplier, tag):
    def ctor(**kwargs):
        return cls(multiplier, **_strip(kwargs))

    ctor.__name__ = ctor.__qualname__ = tag
    ctor.__doc__ = f"{cls.__name__} with width multiplier {multiplier}"
    return ctor


def get_mobilenet(multiplier, **kwargs):
    """Parameterized MobileNet v1 factory (reference mobilenet.py)."""
    return MobileNet(multiplier, **_strip(kwargs))


def get_mobilenet_v2(multiplier, **kwargs):
    """Parameterized MobileNet v2 factory (reference mobilenet.py)."""
    return MobileNetV2(multiplier, **_strip(kwargs))


for _mult, _suffix in ((1.0, "1_0"), (0.75, "0_75"), (0.5, "0_5"),
                       (0.25, "0_25")):
    _f = _mobile_constructor(MobileNet, _mult, f"mobilenet{_suffix}")
    globals()[_f.__name__] = _f
    _f = _mobile_constructor(MobileNetV2, _mult, f"mobilenet_v2_{_suffix}")
    globals()[_f.__name__] = _f
del _mult, _suffix, _f


# ---------------------------------------------------------------------------
# DenseNet — (stem width, growth rate, per-block repeats)
# ---------------------------------------------------------------------------

_DENSE_ROWS = {121: (64, 32, (6, 12, 24, 16)),
               161: (96, 48, (6, 12, 36, 24)),
               169: (64, 32, (6, 12, 32, 32)),
               201: (64, 32, (6, 12, 48, 32))}


def _norm_relu(layout="NCHW"):
    return _chain(nn.BatchNorm(axis=-1 if is_channels_last(layout) else 1),
                  nn.Activation("relu"))


def _grow(growth, bn_size, dropout, layout="NCHW"):
    """BN-relu-1x1-BN-relu-3x3, concatenated onto the running features."""
    body = _chain(_norm_relu(layout),
                  _unit(bn_size * growth, 1, norm=False, act=None,
                        layout=layout),
                  _norm_relu(layout),
                  _unit(growth, 3, p=1, norm=False, act=None, layout=layout))
    if dropout:
        body.add(nn.Dropout(dropout))
    return _WidenJoin(body,
                      channel_dim=-1 if is_channels_last(layout) else 1)


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_unit(num_init_features, 7, 2, 3,
                                    layout=layout))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            width = num_init_features
            for i, reps in enumerate(block_config):
                for _ in range(reps):
                    self.features.add(_grow(growth_rate, bn_size, dropout,
                                            layout=layout))
                width += reps * growth_rate
                if i + 1 < len(block_config):
                    width //= 2
                    self.features.add(_chain(_norm_relu(layout),
                                             _unit(width, 1, norm=False,
                                                   act=None, layout=layout),
                                             nn.AvgPool2D(2, 2,
                                                          layout=layout)))
            self.features.add(_norm_relu(layout))
            self.features.add(nn.AvgPool2D(pool_size=7, layout=layout))
            self.features.add(nn.Flatten())
            self.output = _head(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _dense_constructor(depth):
    def ctor(**kwargs):
        stem, growth, reps = _DENSE_ROWS[depth]
        return DenseNet(stem, growth, reps, **_strip(kwargs))

    ctor.__name__ = ctor.__qualname__ = f"densenet{depth}"
    ctor.__doc__ = f"DenseNet-{depth}"
    return ctor


for _d in _DENSE_ROWS:
    _f = _dense_constructor(_d)
    globals()[_f.__name__] = _f
del _d, _f


# ---------------------------------------------------------------------------
# Inception v3 — cells as branch tables
# ---------------------------------------------------------------------------
# A branch is a tuple of steps; a step is either a pool token
# ("avg"/"max", pool, stride, pad) or a conv row (ch, kernel, stride, pad),
# where kernel/pad may be 2-tuples for the factorized 7x7 paths.

def _iconv(ch, k=1, s=1, p=0, layout="NCHW"):
    return _unit(ch, k, s, p, eps=0.001, layout=layout)


def _branch(steps, layout="NCHW"):
    parts = []
    for step in steps:
        if step[0] == "avg":
            parts.append(nn.AvgPool2D(step[1], step[2], step[3],
                                      layout=layout))
        elif step[0] == "max":
            parts.append(nn.MaxPool2D(step[1], step[2], step[3],
                                      layout=layout))
        else:
            parts.append(_iconv(*step, layout=layout))
    return parts[0] if len(parts) == 1 else _chain(*parts)


def _cell(*branch_specs, layout="NCHW"):
    return _fanout(*(_branch(s, layout) for s in branch_specs),
                   layout=layout)


def _cell_a(tail, lo="NCHW"):
    return _cell(((64, 1),),
                 ((48, 1), (64, 5, 1, 2)),
                 ((64, 1), (96, 3, 1, 1), (96, 3, 1, 1)),
                 (("avg", 3, 1, 1), (tail, 1)), layout=lo)


def _cell_b(lo="NCHW"):
    return _cell(((384, 3, 2, 0),),
                 ((64, 1), (96, 3, 1, 1), (96, 3, 2, 0)),
                 (("max", 3, 2, 0),), layout=lo)


def _cell_c(mid, lo="NCHW"):
    return _cell(((192, 1),),
                 ((mid, 1), (mid, (1, 7), 1, (0, 3)),
                  (192, (7, 1), 1, (3, 0))),
                 ((mid, 1), (mid, (7, 1), 1, (3, 0)),
                  (mid, (1, 7), 1, (0, 3)), (mid, (7, 1), 1, (3, 0)),
                  (192, (1, 7), 1, (0, 3))),
                 (("avg", 3, 1, 1), (192, 1)), layout=lo)


def _cell_d(lo="NCHW"):
    return _cell(((192, 1), (320, 3, 2, 0)),
                 ((192, 1), (192, (1, 7), 1, (0, 3)),
                  (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)),
                 (("max", 3, 2, 0),), layout=lo)


def _split_pair(ch, lo="NCHW"):
    """The E-cell's (1x3 || 3x1) split applied to one stem."""
    return _fanout(_iconv(ch, (1, 3), 1, (0, 1), layout=lo),
                   _iconv(ch, (3, 1), 1, (1, 0), layout=lo), layout=lo)


def _cell_e(lo="NCHW"):
    return _fanout(_iconv(320, 1, layout=lo),
                   _chain(_iconv(384, 1, layout=lo), _split_pair(384, lo)),
                   _chain(_iconv(448, 1, layout=lo),
                          _iconv(384, 3, 1, 1, layout=lo),
                          _split_pair(384, lo)),
                   _chain(nn.AvgPool2D(3, 1, 1, layout=lo),
                          _iconv(192, 1, layout=lo)), layout=lo)


_INCEPTION_STEM = [(32, 3, 2, 0), (32, 3, 1, 0), (64, 3, 1, 1), "P",
                   (80, 1, 1, 0), (192, 3, 1, 0), "P"]


class Inception3(HybridBlock):
    def __init__(self, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        lo = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for row in _INCEPTION_STEM:
                if row == "P":
                    self.features.add(nn.MaxPool2D(3, 2, layout=lo))
                else:
                    self.features.add(_iconv(*row, layout=lo))
            for cell in (_cell_a(32, lo), _cell_a(64, lo), _cell_a(64, lo),
                         _cell_b(lo), _cell_c(128, lo), _cell_c(160, lo),
                         _cell_c(160, lo), _cell_c(192, lo), _cell_d(lo),
                         _cell_e(lo), _cell_e(lo)):
                self.features.add(cell)
            self.features.add(nn.AvgPool2D(pool_size=8, layout=lo))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Flatten())
            self.output = _head(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    return Inception3(**_strip(kwargs))
