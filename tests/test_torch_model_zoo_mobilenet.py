"""PyTorch port: one forward of MobileNet v1 and v2 (width 0.25, 32x32,
B=2: depthwise convolutions, ``relu6`` as a ``HybridLambda`` clip, the
inverted residual's ``_SkipJoin``) against the JAX package's, NCHW and
NHWC, in predict mode, the port's weights the reference's; outputs within
rtol 1e-4 / atol 1e-5 of their largest magnitude (the forward of
``test_torch_model_zoo_forward.py``).
"""
import pytest
import torch

import mxnet_tpu_torch as tmx
from test_torch_model_zoo_forward import _forward_pair, _x


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


FAMILIES = {
    "mobilenet0_25": (lambda z, mx, lo: z.mobilenet0_25(classes=10,
                                                        layout=lo),
                      (2, 3, 32, 32)),
    "mobilenet_v2_0_25": (lambda z, mx, lo: z.mobilenet_v2_0_25(
        classes=10, layout=lo), (2, 3, 32, 32)),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward(family, layout):
    make, shape = FAMILIES[family]
    _forward_pair(make, _x(shape), layout, rel=True)
