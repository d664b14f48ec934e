"""PyTorch port: one forward of each non-residual model-zoo family
against the JAX package's, NCHW and NHWC, in predict mode, the port's
weights the reference's (``params_from_jax``): AlexNet and VGG-11 with
BatchNorm at 64x64 and 32x32 (below which their pools refuse; plain VGG
differs only by ``norm=False`` in ``_unit``), SqueezeNet 1.1 at 224x224
(its ``AvgPool2D(13)`` head and ``ceil_mode`` pools; 1.0 differs only
in its plan's rows) and a narrow ``DenseNet`` (growth 4, one layer a block) at 224x224 (its
``AvgPool2D(7)`` head).  MobileNet's are
``test_torch_model_zoo_mobilenet.py``'s, Inception v3's cells
``test_torch_model_zoo.py``'s.  Outputs within rtol 1e-4 / atol 1e-5 of
their largest magnitude.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

JZ, TZ = jmx.gluon.model_zoo.vision, tmx.gluon.model_zoo.vision


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _forward_pair(make, x_nchw, layout, rel=False):
    """Both packages' nets from ``make(vision_module, layout)``, the
    port's weights the reference's, one predict-mode forward."""
    x = x_nchw.transpose(0, 2, 3, 1).copy() if layout == "NHWC" \
        else x_nchw
    a, b = make(JZ, jmx, layout), make(TZ, tmx, layout)
    a.initialize(jmx.init.Xavier(magnitude=2))
    b.initialize(ctx="cpu")
    a(jmx.nd.array(x))
    b(tmx.nd.array(x))
    tmx.gluon.params_from_jax(b, {k: p.data().asnumpy() for k, p in
                                  a.collect_params().items()})
    want = a(jmx.nd.array(x)).asnumpy()
    got = b(tmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape
    if rel:
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


FAMILIES = {
    "alexnet": (lambda z, mx, lo: z.alexnet(classes=10, layout=lo),
                (1, 3, 64, 64)),
    "vgg11_bn": (lambda z, mx, lo: z.vgg11_bn(classes=10, layout=lo),
                 (1, 3, 32, 32)),
    "squeezenet1_1": (lambda z, mx, lo: z.squeezenet1_1(classes=10,
                                                        layout=lo),
                      (1, 3, 224, 224)),
    "densenet": (lambda z, mx, lo: z.DenseNet(8, 4, (1, 1, 1, 1),
                                              classes=10, layout=lo),
                 (1, 3, 224, 224)),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward(family, layout):
    make, shape = FAMILIES[family]
    _forward_pair(make, _x(shape), layout, rel=True)
