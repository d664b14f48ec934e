"""PyTorch port: the Gluon surface and the ops its blocks call, against the
JAX package.

Ops (same numpy inputs through ``mxnet_tpu.ops`` and
``mxnet_tpu_torch.ops``, f32, rtol 1e-5 / atol 1e-5 — XLA:CPU and torch
order their convolution and matmul sums differently): Convolution in NCHW
(OIHW weights) and NHWC (OHWI weights) with stride, padding, groups and
bias; Pooling max/avg/global in both layouts; FullyConnected; Activation;
Flatten; transpose.  Blocks: ``resnet50_v1(layout="NHWC")`` has the
reference's parameter names (root prefix stripped), shapes and
``grad_req`` after one eager forward at 1x32x32x3; ``params_from_jax``
refuses a missing, an extra or a misshapen parameter; the initializers'
statistics; deferred shapes, ``hybridize`` and the nn.Module view.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import gluon as jgluon, nd
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import tensor as jtensor
from mxnet_tpu_torch import gluon as tgluon, initializer as tinit
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import tensor as ttensor

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _both(fn_j, fn_t, *arrays, **kw):
    want = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays),
                **kw)
    got = fn_t(*(None if a is None else torch.from_numpy(a)
                 for a in arrays), **kw)
    return got, want


CONV = [  # layout, stride, pad, groups, bias
    ("NCHW", 1, 0, 1, True), ("NCHW", 2, 1, 2, False),
    ("NHWC", 1, 1, 1, True), ("NHWC", 2, 3, 1, False),
    ("NHWC", (2, 1), (1, 0), 2, True)]


@pytest.mark.parametrize("layout,stride,pad,groups,bias", CONV)
def test_convolution_matches_jax(layout, stride, pad, groups, bias):
    rs = np.random.RandomState(1)
    cin, cout, k = 4, 6, 3
    if layout == "NCHW":
        x = rs.randn(2, cin, 9, 7).astype(np.float32)
        w = rs.randn(cout, cin // groups, k, k).astype(np.float32)
    else:
        x = rs.randn(2, 9, 7, cin).astype(np.float32)
        w = rs.randn(cout, k, k, cin // groups).astype(np.float32)
    b = rs.randn(cout).astype(np.float32) if bias else None
    kw = dict(kernel=(k, k), stride=stride, pad=pad, num_filter=cout,
              num_group=groups, no_bias=not bias, layout=layout)
    got, want = _both(jnn.convolution, tnn.convolution, x, w, b, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if layout == "NHWC":
        # channels-last in, channels-last out, no copy on the way
        assert got.is_contiguous()


POOL = [  # pool_type, global, kernel, stride, pad
    ("max", False, (3, 3), (2, 2), (1, 1)), ("avg", False, (2, 2), (2, 2),
                                             (0, 0)),
    ("avg", False, (3, 3), (1, 1), (1, 1)), ("max", True, (1, 1), (), ()),
    ("avg", True, (1, 1), (), ())]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,global_pool,kernel,stride,pad", POOL)
def test_pooling_matches_jax(layout, pool_type, global_pool, kernel, stride,
                             pad):
    shape = (2, 3, 9, 8) if layout == "NCHW" else (2, 9, 8, 3)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    kw = dict(kernel=kernel, pool_type=pool_type, global_pool=global_pool,
              stride=stride, pad=pad, layout=layout)
    got, want = _both(jnn.pooling, tnn.pooling, x, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if layout == "NHWC" and not global_pool:
        assert got.is_contiguous()


def test_pooling_refuses_what_is_not_ported():
    x = torch.zeros(1, 3, 4, 4)
    with pytest.raises(MXNetError, match="pooling_convention"):
        tnn.pooling(x, kernel=(2, 2), pooling_convention="full")
    with pytest.raises(MXNetError, match="exceeds padded input"):
        tnn.pooling(x, kernel=(5, 5))


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_matches_jax(flatten):
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3, 5).astype(np.float32)
    w = rs.randn(7, 15 if flatten else 5).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    got, want = _both(jnn.fully_connected, tnn.fully_connected, x, w, b,
                      num_hidden=7, flatten=flatten)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    x = np.random.RandomState(4).randn(3, 8).astype(np.float32) * 3
    got, want = _both(jnn.activation, tnn.activation, x, act_type=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tensor_ops_match_jax():
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    got, want = _both(jtensor.flatten, ttensor.flatten, x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, want = _both(jtensor.transpose, ttensor.transpose, x,
                      axes=(0, 2, 3, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, want = _both(jtensor.transpose, ttensor.transpose, x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the op namespace resolves names and aliases as the reference's does
    y = torch.from_numpy(x)
    assert torch.equal(tnd.broadcast_add(y, y), y + y)
    assert torch.equal(tnd.Flatten(y), tnd.flatten(y))
    for name in ("Convolution", "BatchNorm", "Pooling", "FullyConnected",
                 "Activation", "elemwise_add"):
        assert callable(getattr(tnd, name))


@pytest.fixture(scope="module")
def resnet50_names():
    """The reference's resnet50_v1(layout="NHWC") after one eager forward:
    {stripped name: (shape, grad_req)}."""
    state = np.random.get_state()   # the reference initializer draws here
    try:
        net = jgluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                  layout="NHWC")
        net.initialize()
        net(nd.array(np.zeros((1, 32, 32, 3), np.float32)))
    finally:
        np.random.set_state(state)
    return {k[len(net.prefix):]: (tuple(p.shape), p.grad_req)
            for k, p in net.collect_params().items()}


def test_resnet50_names_and_shapes_match_jax(resnet50_names):
    net = tgluon.model_zoo.vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(ctx="cpu")
    with pytest.raises(DeferredInitializationError):
        net.collect_params()[net.prefix + "conv2d0_weight"].data()
    with torch.no_grad():
        out = net(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, 1000)
    got = {k[len(net.prefix):]: (tuple(p.shape), p.grad_req)
           for k, p in net.collect_params().items()}
    assert list(got) == list(resnet50_names)
    assert got == resnet50_names
    # parameters stored OIHW whatever the layout
    assert got["conv2d0_weight"][0] == (64, 3, 7, 7)
    # the nn.Module view: every parameter registered, aux without grad
    sd = net.state_dict()
    assert len(sd) == len(got)
    assert sum(p.requires_grad for p in net.parameters()) == sum(
        req != "null" for _, req in got.values())
    assert sum(1 for m in net.modules()
               if isinstance(m, tgluon.nn.BatchNorm)) == 53


def test_params_from_jax_refuses_mismatches():
    def arrays_of(net):
        return {k: np.full(p.shape, 0.5, np.float32)
                for k, p in net.collect_params().items()}

    state = np.random.get_state()
    try:
        jnet = jgluon.model_zoo.vision.resnet18_v1(classes=10)
        jnet.initialize()
        jnet(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    finally:
        np.random.set_state(state)
    tnet = tgluon.model_zoo.vision.resnet18_v1(classes=10)
    tnet.initialize(ctx="cpu")
    with torch.no_grad():
        tnet(torch.zeros(1, 3, 32, 32))
    good = arrays_of(jnet)
    tgluon.params_from_jax(tnet, good)
    assert all(bool((p.data().asnumpy() == 0.5).all())
               for p in tnet.collect_params().values())
    first = next(iter(good))
    missing = {k: v for k, v in good.items() if k != first}
    with pytest.raises(MXNetError, match="missing"):
        tgluon.params_from_jax(tnet, missing)
    extra = dict(good, **{jnet.prefix + "dense9_weight": np.zeros(3)})
    with pytest.raises(MXNetError, match="extra"):
        tgluon.params_from_jax(tnet, extra)
    bad = dict(good)
    bad[first] = np.zeros((1,) + good[first].shape[1:], np.float32)
    with pytest.raises(MXNetError, match="shape"):
        tgluon.params_from_jax(tnet, bad)
    fresh = tgluon.model_zoo.vision.resnet18_v1(classes=10)
    fresh.initialize(ctx="cpu")
    with pytest.raises(MXNetError, match="not initialized"):
        tgluon.params_from_jax(fresh, good)


def test_initializer_statistics():
    g = torch.Generator().manual_seed(0)
    w = torch.empty(400, 500)
    tinit.Uniform(0.07)("conv0_weight", w, g)
    assert float(w.abs().max()) <= 0.07
    assert abs(float(w.mean())) < 1e-3
    np.testing.assert_allclose(float(w.var()), 0.07 ** 2 / 3, rtol=0.02)
    tinit.Normal(0.5)("dense0_weight", w, g)
    assert abs(float(w.mean())) < 5e-3
    np.testing.assert_allclose(float(w.std()), 0.5, rtol=0.02)
    k = torch.empty(64, 32, 3, 3)
    tinit.create("xavier")("conv0_weight", k, g)
    bound = np.sqrt(3.0 / ((32 * 9 + 64 * 9) / 2.0))
    assert float(k.abs().max()) <= bound
    np.testing.assert_allclose(float(k.var()), bound ** 2 / 3, rtol=0.05)
    # name-pattern defaults, whatever the initializer
    for name, want in (("bn_gamma", 1.0), ("bn_beta", 0.0),
                       ("bn_running_mean", 0.0), ("bn_running_var", 1.0),
                       ("fc_bias", 0.0)):
        t = torch.full((5,), 7.0)
        tinit.Uniform()(name, t, g)
        assert bool((t == want).all()), name
    for name, value in (("zeros", 0.0), ("ones", 1.0)):
        t = torch.full((3, 3), 7.0)
        tinit.create(name)("w_weight", t)
        assert bool((t == value).all())
    t = torch.zeros(2, 2)
    tinit.create("constant", value=2.5)("w_weight", t)
    assert bool((t == 2.5).all())
    # the same generator seed gives the same weights
    a, b = torch.empty(8, 8), torch.empty(8, 8)
    tinit.Uniform()("w_weight", a, torch.Generator().manual_seed(3))
    tinit.Uniform()("w_weight", b, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown initializer"):
        tinit.create("nope")


def test_blocks_prefixes_hybridize_and_model_zoo():
    from mxnet_tpu_torch import autograd

    a = tgluon.nn.Dense(4, in_units=3)
    b = tgluon.nn.Dense(4)
    assert a.prefix != b.prefix and a.prefix.startswith("dense")
    seq = tgluon.nn.HybridSequential()
    with seq.name_scope():
        seq.add(tgluon.nn.Dense(5), tgluon.nn.Activation("relu"),
                tgluon.nn.Dense(2))
    names = list(seq.collect_params())
    assert names == [seq.prefix + n for n in (
        "dense0_weight", "dense0_bias", "dense1_weight", "dense1_bias")]
    seq.initialize(ctx="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 7)
    eager = seq(x)
    seq.hybridize()
    assert seq._active and all(c._active for c in seq._children.values())
    assert torch.equal(seq(x), eager)
    assert not autograd.is_training()
    with autograd.record():
        assert autograd.is_training() and autograd.is_recording()
        with autograd.pause(train_mode=True):
            assert autograd.is_training() and not autograd.is_recording()
        with autograd.predict_mode():
            assert not autograd.is_training()
    assert not autograd.is_training()
    with pytest.raises(RuntimeError, match="pretrained"):
        tgluon.model_zoo.vision.get_resnet(1, 18, pretrained=True)
    with pytest.raises(ValueError, match="unknown model"):
        tgluon.model_zoo.get_model("vgg16")
    net = tgluon.model_zoo.get_model("resnet18_v2", classes=3,
                                     thumbnail=True, layout="NHWC")
    assert isinstance(net, tgluon.model_zoo.vision.ResNetV2)


def test_op_registry():
    from mxnet_tpu_torch.ops import registry

    assert {"BatchNorm", "Convolution", "FullyConnected", "Pooling",
            "Activation", "elemwise_add", "flatten",
            "transpose"} <= set(registry.list_ops())
    bn = registry.get_op("BatchNorm")
    assert bn.n_outputs({"output_mean_var": True}) == 3
    assert bn.n_outputs({}) == 1
    assert registry.get_op("Flatten") is registry.get_op("flatten")
    with pytest.raises(KeyError, match="not registered"):
        registry.get_op("NoSuchOp")
    with pytest.raises(ValueError, match="already registered"):
        registry.register("BatchNorm")(lambda x: x)
    with pytest.raises(ValueError, match="alias"):
        registry.register("fresh_name_for_test", aliases=("Flatten",))(
            lambda x: x)
    assert "fresh_name_for_test" not in registry.OP_REGISTRY
