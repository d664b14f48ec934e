"""Residual networks for the Gluon model zoo.

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
depths 18/34/50/101/152 in the post-activation (v1) and pre-activation
(v2) forms, with the reference's constructor surface (``get_resnet``,
``resnet50_v1`` etc., ``ResNetV1(block, layers, channels, ...)``) and its
parameter names.  One ``_ResidualUnit`` interprets a conv plan of
``(width, kernel, stride, pad, bias)`` steps in either order, and one
``_ResNet`` trunk assembles stem, stages and head from a per-depth table.

Every constructor takes ``layout="NHWC"`` for the channels-last variant,
whose BatchNorms normalize the last axis and so run the port's CUDA
BatchNorm kernels in training; activations stay contiguous NHWC from conv
to BatchNorm, relu, the residual add and pooling.  Parameters are stored
OIHW either way, so checkpoints swap freely between layouts.
"""
from __future__ import annotations

from ....ops.nn import is_channels_last
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet"]
# resnet{18,34,50,101,152}_v{1,2} are appended to __all__ at module bottom
# (they are generated, not hand-written).


# ---------------------------------------------------------------------------
# one residual unit, interpreting a conv plan in post- or pre-act order
# ---------------------------------------------------------------------------

def _pair_plan(width, stride):
    """Two 3x3 convs (the shallow-net unit)."""
    return ((width, 3, stride, 1, False),
            (width, 3, 1, 1, False))


def _triple_plan(width, stride, preact):
    """1x1 reduce -> 3x3 -> 1x1 expand (the deep-net unit).

    Stride placement differs by version: post-act nets stride the leading
    1x1, pre-act nets stride the 3x3 (matching the reference's semantics).
    """
    inner = width // 4
    if preact:
        return ((inner, 1, 1, 0, False),
                (inner, 3, stride, 1, False),
                (width, 1, 1, 0, False))
    return ((inner, 1, stride, 0, True),
            (inner, 3, 1, 1, False),
            (width, 1, 1, 0, True))


def _bn(layout, **kw):
    return nn.BatchNorm(axis=-1 if is_channels_last(layout) else 1, **kw)


class _ResidualUnit(HybridBlock):
    """y = act-arrangement(convs(x)) + shortcut(x).

    ``plan`` is a tuple of ``(width, kernel, stride, pad, bias)`` conv steps.
    ``preact=False`` runs conv->BN->relu with the final relu applied after
    the skip-add; ``preact=True`` runs a shared BN->relu first, branches the
    (projected) shortcut off the activated tensor, then interleaves
    BN->relu *between* convs, with a bare add at the end.
    ``project`` is ``None`` for an identity shortcut or ``(width, stride)``
    for a 1x1 projection (BN'd only in post-act form, as in the reference).
    """

    def __init__(self, plan, preact, project, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._preact = preact
        lo = layout
        with self.name_scope():
            if preact:
                self.gate = _bn(lo)
                self.trunk = nn.HybridSequential(prefix="")
                for i, (w, k, s, p, b) in enumerate(plan):
                    if i:
                        self.trunk.add(_bn(lo))
                        self.trunk.add(nn.Activation("relu"))
                    self.trunk.add(nn.Conv2D(w, k, s, p, use_bias=b, layout=lo))
                self.shortcut = (nn.Conv2D(project[0], 1, project[1],
                                           use_bias=False, layout=lo)
                                 if project else None)
            else:
                self.trunk = nn.HybridSequential(prefix="")
                last = len(plan) - 1
                for i, (w, k, s, p, b) in enumerate(plan):
                    self.trunk.add(nn.Conv2D(w, k, s, p, use_bias=b, layout=lo))
                    self.trunk.add(_bn(lo))
                    if i != last:
                        self.trunk.add(nn.Activation("relu"))
                if project:
                    sc = nn.HybridSequential(prefix="")
                    sc.add(nn.Conv2D(project[0], 1, project[1],
                                     use_bias=False, layout=lo))
                    sc.add(_bn(lo))
                    self.shortcut = sc
                else:
                    self.shortcut = None

    def hybrid_forward(self, F, x):
        if self._preact:
            h = F.Activation(self.gate(x), act_type="relu")
            skip = x if self.shortcut is None else self.shortcut(h)
            return self.trunk(h) + skip
        y = self.trunk(x)
        skip = x if self.shortcut is None else self.shortcut(x)
        return F.Activation(y + skip, act_type="relu")


# Reference-API block classes, kept as thin plan adapters so user code can
# still instantiate them directly.

class BasicBlockV1(_ResidualUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_pair_plan(channels, stride), preact=False,
                         project=(channels, stride) if downsample else None,
                         **kwargs)


class BottleneckV1(_ResidualUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_triple_plan(channels, stride, preact=False),
                         preact=False,
                         project=(channels, stride) if downsample else None,
                         **kwargs)


class BasicBlockV2(_ResidualUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_pair_plan(channels, stride), preact=True,
                         project=(channels, stride) if downsample else None,
                         **kwargs)


class BottleneckV2(_ResidualUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(_triple_plan(channels, stride, preact=True),
                         preact=True,
                         project=(channels, stride) if downsample else None,
                         **kwargs)


# ---------------------------------------------------------------------------
# the trunk: stem -> 4 stages of repeated units -> classifier head
# ---------------------------------------------------------------------------

class _ResNet(HybridBlock):
    """Assembles a residual net from a block class and per-stage repeats.

    ``channels`` follows the reference convention: ``channels[0]`` is the
    stem width, ``channels[1:]`` the per-stage output widths.
    """

    def __init__(self, block, layers, channels, preact, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel entry per stage plus the stem")
        self._preact = preact
        lo = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if preact:
                # un-affine BN on raw input: the v2 papers' input whitening
                self.features.add(_bn(lo, scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False, layout=lo))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=lo))
                self.features.add(_bn(lo))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=lo))
            width_in = channels[0]
            for stage, (reps, width) in enumerate(zip(layers, channels[1:])):
                with self.features.name_scope():
                    run = nn.HybridSequential(prefix=f"stage{stage + 1}_")
                    with run.name_scope():
                        run.add(block(width, 1 if stage == 0 else 2,
                                      downsample=width != width_in,
                                      in_channels=width_in, layout=lo,
                                      prefix=""))
                        for _ in range(reps - 1):
                            run.add(block(width, 1, in_channels=width,
                                          layout=lo, prefix=""))
                self.features.add(run)
                width_in = width
            if preact:
                self.features.add(_bn(lo))
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=lo))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=width_in)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """Post-activation residual net (He et al. 2015 arrangement)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(block, layers, channels, preact=False,
                         classes=classes, thumbnail=thumbnail, **kwargs)


class ResNetV2(_ResNet):
    """Pre-activation residual net (He et al. 2016 arrangement)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(block, layers, channels, preact=True,
                         classes=classes, thumbnail=thumbnail, **kwargs)


# ---------------------------------------------------------------------------
# depth table + generated constructors
# ---------------------------------------------------------------------------

# depth -> (per-stage repeats, unit kind). Stage widths are computed, not
# tabulated: pair units keep the stem's 64-ch scale, triple units expand 4x.
_DEPTH_PLANS = {
    18: ((2, 2, 2, 2), "pair"),
    34: ((3, 4, 6, 3), "pair"),
    50: ((3, 4, 6, 3), "triple"),
    101: ((3, 4, 23, 3), "triple"),
    152: ((3, 8, 36, 3), "triple"),
}

_BLOCK_FOR = {(1, "pair"): BasicBlockV1, (1, "triple"): BottleneckV1,
              (2, "pair"): BasicBlockV2, (2, "triple"): BottleneckV2}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Build a ResNet by version (1 post-act / 2 pre-act) and depth."""
    if num_layers not in _DEPTH_PLANS:
        raise ValueError(f"no ResNet-{num_layers}; "
                         f"choose from {sorted(_DEPTH_PLANS)}")
    if version not in (1, 2):
        raise ValueError(f"version must be 1 or 2, got {version}")
    repeats, kind = _DEPTH_PLANS[num_layers]
    base = 64 if kind == "pair" else 256
    channels = [64] + [base << i for i in range(len(repeats))]
    net_cls = ResNetV1 if version == 1 else ResNetV2
    net = net_cls(_BLOCK_FOR[(version, kind)], list(repeats), channels,
                  **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (no egress)")
    return net


def _make_constructor(version, depth):
    def ctor(**kwargs):
        return get_resnet(version, depth, **kwargs)

    kind = "post" if version == 1 else "pre"
    ctor.__name__ = ctor.__qualname__ = f"resnet{depth}_v{version}"
    ctor.__doc__ = f"ResNet-{depth}, {kind}-activation form."
    return ctor


for _depth in _DEPTH_PLANS:
    for _version in (1, 2):
        _fn = _make_constructor(_version, _depth)
        globals()[_fn.__name__] = _fn
        __all__.append(_fn.__name__)
del _depth, _version, _fn
