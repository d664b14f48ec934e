"""PyTorch port: the non-residual model zoo and the new ``gluon.nn``
layers against the JAX package's.

- Every ``simple_nets`` constructor (and ``get_model`` alias) gives the
  reference's parameter names (root prefixes stripped) and shapes, in
  both layouts.
- Inception v3's five cell kinds, one forward each, NCHW and NHWC, on a
  16- or 8-channel 17x17 input, predict mode, the port's weights the
  reference's (the whole net needs 299x299: its names are held above,
  and the card trains it), within rtol 1e-4 / atol 1e-5 of the largest
  output magnitude.  The other families' forwards are
  ``test_torch_model_zoo_forward.py``'s.
- Each new layer (``Dropout``, ``Embedding``, ``InstanceNorm``,
  ``LayerNorm``, ``Lambda``, ``HybridLambda``, ``HybridConcatenate``,
  ``Concatenate``, ``Identity``, ``LeakyReLU``, ``PReLU``, ``ELU``,
  ``SELU``, ``GELU``, ``Swish``, ``AvgPool2D``, ``GlobalMaxPool2D``,
  ``MaxPool2D`` with padding and ``ceil_mode``) forward, and its input
  gradient, at rtol 1e-5 / atol 1e-6; LayerNorm over the last axis with
  ``TPUMX_PALLAS=1`` (monkeypatch), so both sides take their fused
  kernel's plain version.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_model_zoo_forward import _forward_pair, _x

TOL = dict(rtol=1e-5, atol=1e-6)
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


def _names(net):
    return [(k[len(net.prefix):], tuple(p.shape or ()))
            for k, p in net.collect_params().items()]


@pytest.mark.parametrize("name", sorted(
    n for n in JZ._models if not n.startswith("resnet")))
def test_constructor_names_and_shapes(name):
    for layout in ("NCHW", "NHWC"):
        a = JZ.get_model(name, classes=10, layout=layout)
        b = TZ.get_model(name, classes=10, layout=layout)
        assert type(a).__name__ == type(b).__name__
        assert _names(a) == _names(b)


def test_zoo_tables_and_refusals():
    assert sorted(JZ._models) == sorted(TZ._models)
    for fn in ("get_vgg", "get_mobilenet", "get_mobilenet_v2"):
        assert hasattr(TZ, fn)
    with pytest.raises(RuntimeError, match="pretrained"):
        TZ.vgg11(pretrained=True)
    a = _names(JZ.get_vgg(13, batch_norm=True, classes=3))
    assert a == _names(TZ.get_vgg(13, batch_norm=True, classes=3))


def _cell(kind):
    """One Inception cell inside a named block (the names the cell's
    layers take inside ``Inception3``'s scope)."""
    def make(z, mx, lo):
        sn = z.simple_nets
        net = mx.gluon.nn.HybridSequential(prefix="cell_")
        with net.name_scope():
            net.add({"a": lambda: sn._cell_a(8, lo),
                     "b": lambda: sn._cell_b(lo),
                     "c": lambda: sn._cell_c(8, lo),
                     "d": lambda: sn._cell_d(lo),
                     "e": lambda: sn._cell_e(lo)}[kind]())
        return net
    return make


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", list("abcde"))
def test_inception_cells_forward(kind, layout):
    _forward_pair(_cell(kind), _x((1, 16 if kind in "ab" else 8, 17, 17)),
                  layout, rel=True)


# -- the new gluon.nn layers --------------------------------------------------

def _layer_pair(make, x):
    """Run ``make(nn)`` of each package on ``x``: outputs (and the input
    gradient of the output's sum), the port's parameters the
    reference's."""
    res = []
    for mx in (jmx, tmx):
        blk = make(mx.gluon.nn)
        blk.initialize(**({"ctx": "cpu"} if mx is tmx else {}))
        xs = mx.nd.array(x)
        blk(xs)
        if mx is tmx and list(blk.collect_params()):
            tmx.gluon.params_from_jax(blk, ref_params)
        ref_params = {k: p.data().asnumpy()
                      for k, p in blk.collect_params().items()}
        xs.attach_grad()
        with mx.autograd.record(train_mode=False):
            out = blk(xs)
            total = out.sum()
        total.backward()
        res.append((out.asnumpy(), xs.grad.asnumpy()))
    return res


LAYERS = {
    "dropout_infer": (lambda nn: nn.Dropout(0.4), (3, 5, 4)),
    "identity": (lambda nn: nn.Identity(), (2, 3)),
    "leaky": (lambda nn: nn.LeakyReLU(0.1), (3, 7)),
    "prelu": (lambda nn: nn.PReLU(), (3, 7)),
    "elu": (lambda nn: nn.ELU(0.7), (3, 7)),
    "selu": (lambda nn: nn.SELU(), (3, 7)),
    "gelu": (lambda nn: nn.GELU(), (3, 7)),
    "swish": (lambda nn: nn.Swish(1.5), (3, 7)),
    "instancenorm": (lambda nn: nn.InstanceNorm(scale=True), (2, 3, 5, 4)),
    "instancenorm_last": (lambda nn: nn.InstanceNorm(axis=-1, scale=True),
                          (2, 5, 4, 3)),
    "layernorm_last": (lambda nn: nn.LayerNorm(), (4, 6, 16)),
    "layernorm_axis1": (lambda nn: nn.LayerNorm(axis=1), (4, 6, 5)),
    "hybridlambda_str": (lambda nn: nn.HybridLambda("tanh"), (3, 4)),
    "hybridlambda_fn": (lambda nn: nn.HybridLambda(
        lambda F, x: F.clip(x, -0.5, 0.5)), (3, 4)),
    "avgpool_pad": (lambda nn: nn.AvgPool2D(3, 1, 1), (2, 3, 6, 6)),
    "avgpool_nopad_count": (lambda nn: nn.AvgPool2D(
        3, 2, 1, count_include_pad=False), (2, 3, 7, 7)),
    "avgpool_ceil": (lambda nn: nn.AvgPool2D(3, 2, ceil_mode=True),
                     (2, 3, 8, 8)),
    "avgpool_ceil_nhwc": (lambda nn: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False, layout="NHWC"),
        (2, 8, 8, 3)),
    "maxpool_pad": (lambda nn: nn.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
    "maxpool_ceil_nhwc": (lambda nn: nn.MaxPool2D(3, 2, ceil_mode=True,
                                                  layout="NHWC"),
                          (2, 8, 8, 3)),
    "globalmaxpool": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "globalmaxpool_nhwc": (lambda nn: nn.GlobalMaxPool2D(layout="NHWC"),
                           (2, 5, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name, monkeypatch):
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    make, shape = LAYERS[name]
    (a, ga), (b, gb) = _layer_pair(make, _x(shape, 3))
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(gb, ga, **TOL)


def _concat(nn, cls):
    blk = getattr(nn, cls)(axis=1, prefix="cat_")
    with blk.name_scope():
        blk.add(nn.Dense(3, in_units=4), nn.Identity(),
                nn.HybridLambda(lambda F, x: F.relu(x)))
    return blk


@pytest.mark.parametrize("cls", ["HybridConcatenate", "Concatenate"])
def test_concatenate(cls):
    (a, ga), (b, gb) = _layer_pair(lambda nn: _concat(nn, cls),
                                   _x((2, 4), 4))
    assert b.shape == (2, 11)
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(gb, ga, **TOL)


def test_embedding_and_lambda():
    idx = np.array([[0, 3, 9], [2, 2, 7]], np.float32)
    outs = []
    for mx in (jmx, tmx):
        emb = mx.gluon.nn.Embedding(10, 6)
        emb.initialize(**({"ctx": "cpu"} if mx is tmx else {}))
        emb(mx.nd.array(idx))
        if mx is tmx:
            tmx.gluon.params_from_jax(emb, w)
        w = {k: p.data().asnumpy() for k, p in emb.collect_params().items()}
        with mx.autograd.record():
            out = emb(mx.nd.array(idx))
        out.backward()
        outs.append((out.asnumpy(), emb.weight.grad().asnumpy()))
        lam = mx.gluon.nn.Lambda("exp")
        assert lam(mx.nd.array([[0.0]])).asnumpy()[0, 0] == 1.0
    (a, ga), (b, gb) = outs
    assert b.shape == (2, 3, 6)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(gb, ga, **TOL)


def test_dropout_layer_training_masks():
    x = _x((4, 8, 6), 5) + 3.0
    res = []
    for mx in (jmx, tmx):
        mx.random.seed(17)
        blk = mx.gluon.nn.Dropout(0.5, axes=(1,))
        with mx.autograd.record():
            res.append(blk(mx.nd.array(x)).asnumpy())
    np.testing.assert_array_equal(res[0] != 0, res[1] != 0)
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)
