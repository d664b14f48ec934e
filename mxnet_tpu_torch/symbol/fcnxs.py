"""FCN-32s on VGG-16 as a symbol: the public MXNet ``example/fcn-xs``
``symbol_fcnxs.py`` ``get_fcn32s_symbol``, written from its published
description.

The VGG-16 trunk (``conv1_1`` padded by 100, five groups of 3x3
convolutions each closed by a 2x2 max pool), ``fc6`` as a 7x7 convolution
and ``fc7`` as a 1x1 one (each with ReLU and Dropout 0.5), the 1x1
``score`` convolution over ``numclass`` classes, ``bigscore`` (a
Deconvolution of kernel 64, stride 32, ``adj`` 31, no bias, meant to be
initialized by ``init.Bilinear``), ``upscore`` (``Crop`` against ``data``
from offset 19) and ``softmax`` (``SoftmaxOutput`` per pixel, label 255
ignored).

``sym`` is the symbol namespace to build with (``mx.sym``): the function
uses nothing else, so the same code builds the graph under any package
with the reference's symbol API.  ``widths`` (the five groups'
channels), ``fc_width`` and ``dropout`` narrow the net for tests; the
defaults are the published ones.
"""
from __future__ import annotations

__all__ = ["get_fcn32s_symbol", "VGG16_WIDTHS"]

VGG16_WIDTHS = (64, 128, 256, 512, 512)
_DEPTHS = (2, 2, 3, 3, 3)


def get_fcn32s_symbol(sym, numclass=21, widths=VGG16_WIDTHS, fc_width=4096,
                      dropout=0.5, workspace_default=1024):
    data = sym.Variable(name="data")
    x = data
    for g, (width, depth) in enumerate(zip(widths, _DEPTHS), start=1):
        for i in range(1, depth + 1):
            pad = (100, 100) if (g, i) == (1, 1) else (1, 1)
            x = sym.Convolution(data=x, kernel=(3, 3), pad=pad,
                                num_filter=width,
                                workspace=workspace_default,
                                name=f"conv{g}_{i}")
            x = sym.Activation(data=x, act_type="relu", name=f"relu{g}_{i}")
        x = sym.Pooling(data=x, pool_type="max", kernel=(2, 2),
                        stride=(2, 2), name=f"pool{g}")
    for n, k in ((6, (7, 7)), (7, (1, 1))):
        x = sym.Convolution(data=x, kernel=k, num_filter=fc_width,
                            workspace=workspace_default, name=f"fc{n}")
        x = sym.Activation(data=x, act_type="relu", name=f"relu{n}")
        x = sym.Dropout(data=x, p=dropout, name=f"drop{n}")
    score = sym.Convolution(data=x, kernel=(1, 1), num_filter=numclass,
                            workspace=workspace_default, name="score")
    bigscore = sym.Deconvolution(data=score, kernel=(64, 64), stride=(32, 32),
                                 adj=(31, 31), num_filter=numclass,
                                 no_bias=True, workspace=workspace_default,
                                 name="bigscore")
    upscore = sym.Crop(*[bigscore, data], offset=(19, 19), name="upscore")
    return sym.SoftmaxOutput(data=upscore, multi_output=True,
                             use_ignore=True, ignore_label=255,
                             name="softmax")
