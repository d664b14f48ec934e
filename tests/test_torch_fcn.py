"""PyTorch port: FCN-32s (``symbol/fcnxs.py``) and the graphs of three of the
repo's examples against the JAX package.

- FCN-32s at narrowed widths (VGG channels / 16, fc6/fc7 at 64, 21
  classes): the graph JSON byte for byte the reference's, its
  ``load_json`` in the port, ``init.Bilinear`` on ``bigscore_weight``
  equal to a numpy bilinear filter, and two ``Module.fit`` steps (B=2,
  64x64, labels with 255s) from the same ``arg_params``: per-step loss
  and the parameters after them at rtol 1e-4.  ``bigscore_weight`` is
  the bilinear filter per class, as the public ``init_fcnxs.py`` sets
  it, so the logits differ by class and every layer gets a gradient.  The fit runs the graph
  with Dropout at p=0: each package keys a symbolic Dropout node by its
  own per-process node id, so masks differ across packages.
- ``svm_mnist``'s net (``SVMOutput``, L1 and L2), ``neural-style``'s Gram
  matrix through ``batch_dot`` and ``api_tour``'s ``Group`` of
  ``softmax`` and ``BlockGrad``: JSON bytes, ``load_json``, and the bound
  graph's outputs and gradients (rtol 1e-5).
- The Gluon conv layers of 1-D and 3-D, transposed, their pools and
  ``ReflectionPad2D``): parameter names and shapes, and outputs from the
  same weights (rtol 1e-5).
- The initializers ``Orthogonal``, ``MSRAPrelu``, ``Bilinear``,
  ``LSTMBias``, ``FusedRNN`` and ``Mixed``: after the same
  ``np.random.seed`` the reference's bytes, made by the reference's
  names through ``init.create``, with the same ``dumps()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.symbol.fcnxs import get_fcn32s_symbol

NARROW = dict(widths=(4, 8, 16, 32, 32), fc_width=64)
TOL = dict(rtol=1e-4, atol=1e-6)
TOL5 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _fcn(pkg, **kw):
    with pkg.name.NameManager():
        return get_fcn32s_symbol(pkg.sym, **dict(NARROW, **kw))


def test_fcn32s_json_bytes_and_load():
    js, ts = _fcn(jmx), _fcn(tmx)
    assert ts.tojson() == js.tojson()
    back = tmx.sym.load_json(js.tojson())
    assert back.tojson() == js.tojson()
    shapes = ts.infer_shape(data=(2, 3, 64, 64))
    assert shapes == js.infer_shape(data=(2, 3, 64, 64))
    assert dict(zip(ts.list_arguments(), shapes[0]))["bigscore_weight"] \
        == (21, 21, 64, 64)


def _bilinear(k):
    f = np.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:k, :k]
    return ((1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))).astype(
        np.float32)


def _data(n=4, hw=64, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 3, hw, hw).astype(np.float32)
    Y = rs.randint(0, 21, (n, hw, hw)).astype(np.float32)
    Y[:, :8, :] = 255.0          # an ignored band
    return X, Y


def _arg_params(sym):
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(2, 3, 64, 64))[0]))
    rs = np.random.RandomState(1)
    out = {}
    for name, shp in sorted(shapes.items()):
        if name in ("data", "softmax_label"):
            continue
        if name == "bigscore_weight":   # per class, as init_fcnxs.py does
            out[name] = np.zeros(shp, np.float32)
            out[name][range(shp[0]), range(shp[1])] = _bilinear(64)
        elif name.endswith("bias"):
            out[name] = (rs.randn(*shp) * 0.01).astype(np.float32)
        else:
            fan_in = int(np.prod(shp[1:]))
            out[name] = (rs.randn(*shp) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
    return out


def _loss(probs, label):
    p = np.moveaxis(probs, 1, -1).reshape(-1, probs.shape[1])
    lab = label.reshape(-1)
    keep = lab != 255
    picked = p[keep, lab[keep].astype(np.int64)]
    return float(-np.log(np.maximum(picked, 1e-12)).mean())


def _fit_two_steps(pkg):
    sym = _fcn(pkg, dropout=0.0)
    X, Y = _data()
    it = pkg.io.NDArrayIter(X, Y, batch_size=2, shuffle=False)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    losses, labels = [], [Y[0:2], Y[2:4]]

    def after_batch(param):
        out = mod.get_outputs()[0].asnumpy()
        losses.append(_loss(out, labels[param.nbatch]))

    params = {k: pkg.nd.array(v) for k, v in _arg_params(sym).items()}
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.99,
                              "wd": 5e-4},
            arg_params=params, batch_end_callback=after_batch,
            eval_metric=pkg.metric.Loss())
    arg, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in arg.items()}


def test_fcn32s_two_fit_steps_match():
    jl, jp = _fit_two_steps(jmx)
    tl, tp = _fit_two_steps(tmx)
    assert len(tl) == len(jl) == 2 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **TOL)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], **TOL, err_msg=k)
    # the trunk's gradients are not zero: the logits differ by class, and
    # the first layer ends far from where weight decay alone (two SGD
    # momentum steps, no gradient) would take it
    assert abs(jl[0] - np.log(21)) > 0.1
    w0 = _arg_params(_fcn(tmx))["conv1_1_weight"]
    lr, mom, wd = 0.1, 0.99, 5e-4
    w1 = w0 * (1 - lr * wd)
    w2 = w1 + mom * (-lr * wd * w0) - lr * wd * w1
    assert np.abs(jp["conv1_1_weight"] - w2).max() > 1e-2 * np.abs(w0).max()


def test_fcn32s_bilinear_init():
    sym = _fcn(tmx)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (1, 3, 64, 64))],
             label_shapes=[("softmax_label", (1, 64, 64))])
    mod.init_params(initializer=tmx.init.Mixed(
        ["bigscore_weight", ".*"],
        [tmx.init.Bilinear(), tmx.init.Xavier(magnitude=2)]))
    w = mod.get_params()[0]["bigscore_weight"].asnumpy()
    np.testing.assert_array_equal(w, np.broadcast_to(_bilinear(64), w.shape))
    assert tmx.init.create("bilinear").dumps() == \
        jmx.init.create("bilinear").dumps()


# ---------------------------------------------------------------------------
# the examples' graphs
# ---------------------------------------------------------------------------

def _svm(pkg, use_linear):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        h = sym.Activation(sym.FullyConnected(data, num_hidden=16),
                           act_type="relu")
        fc = sym.FullyConnected(h, num_hidden=10, name="fc3")
        return sym.SVMOutput(fc, sym.Variable("svm_label"),
                             regularization_coefficient=1.0,
                             use_linear=use_linear, name="svm")


def _gram(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        feat = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                               name="conv")
        flat = sym.reshape(feat, shape=(0, 0, -1))
        g = sym.batch_dot(flat, sym.transpose(flat, axes=(0, 2, 1))) / 36.0
        return sym.MakeLoss(sym.sum(sym.square(g)), name="style")


def _api_tour(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        fc = sym.FullyConnected(data, num_hidden=4, name="fc")
        return sym.Group([sym.softmax(fc), sym.BlockGrad(fc)])


EXAMPLES = {
    "svm_l2": (lambda pkg: _svm(pkg, False), {"data": (5, 8),
                                              "svm_label": (5,)}),
    "svm_l1": (lambda pkg: _svm(pkg, True), {"data": (5, 8),
                                             "svm_label": (5,)}),
    "gram": (_gram, {"data": (2, 3, 6, 6)}),
    "api_tour": (_api_tour, {"data": (2, 3)}),
}


def _run_graph(pkg, sym, shapes):
    exe = sym.simple_bind(ctx=pkg.cpu(), **shapes)
    rs = np.random.RandomState(3)
    for name, arr in exe.arg_dict.items():
        if name == "svm_label":
            arr[:] = pkg.nd.array(rs.randint(0, 10, arr.shape).astype(
                np.float32))
        else:
            arr[:] = pkg.nd.array(rs.randn(*arr.shape).astype(np.float32))
    outs = exe.forward(is_train=True)
    outs = [o.asnumpy() for o in outs]
    exe.backward([pkg.nd.ones(o.shape) for o in outs])
    grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()
             if v is not None and k != "svm_label"}
    return outs, grads


@pytest.mark.parametrize("case", sorted(EXAMPLES))
def test_example_graphs(case):
    build, shapes = EXAMPLES[case]
    js, ts = build(jmx), build(tmx)
    assert ts.tojson() == js.tojson()
    ts = tmx.sym.load_json(js.tojson())
    jo, jg = _run_graph(jmx, js, shapes)
    to, tg = _run_graph(tmx, ts, shapes)
    assert len(to) == len(jo)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t, j, **TOL5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **TOL5, err_msg=k)
    if case == "api_tour":   # BlockGrad stops the second head's gradient
        assert np.abs(tg["fc_weight"]).sum() > 0


# ---------------------------------------------------------------------------
# Gluon conv layers
# ---------------------------------------------------------------------------

LAYERS = {
    "Conv1D": ((2, 3, 9), dict(channels=4, kernel_size=3, strides=2,
                               padding=1)),
    "Conv3D": ((1, 2, 4, 5, 3), dict(channels=3, kernel_size=(2, 3, 2),
                                     use_bias=False)),
    "Conv1DTranspose": ((2, 3, 5), dict(channels=4, kernel_size=3,
                                        strides=2, output_padding=1)),
    "Conv2DTranspose": ((1, 4, 5, 4), dict(channels=6, kernel_size=(3, 2),
                                           strides=(2, 2), padding=(1, 0),
                                           groups=2)),
    "Conv3DTranspose": ((1, 2, 3, 3, 2), dict(channels=2, kernel_size=2,
                                              strides=2)),
    "MaxPool1D": ((2, 3, 9), dict(pool_size=3, strides=2)),
    "MaxPool3D": ((1, 2, 4, 6, 4), dict(ceil_mode=True)),
    "AvgPool1D": ((2, 3, 9), dict(pool_size=2, padding=1,
                                  count_include_pad=False)),
    "AvgPool3D": ((1, 2, 4, 4, 6), dict(pool_size=(2, 2, 3))),
    "GlobalMaxPool1D": ((2, 3, 9), {}),
    "GlobalAvgPool1D": ((2, 3, 9), {}),
    "GlobalMaxPool3D": ((1, 2, 3, 4, 2), {}),
    "GlobalAvgPool3D": ((1, 2, 3, 4, 2), {}),
    "ReflectionPad2D": ((1, 2, 4, 5), dict(padding=2)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_gluon_conv_layers(name):
    shape, kw = LAYERS[name]
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jnet = getattr(jmx.gluon.nn, name)(prefix="l_", **kw)
    tnet = getattr(tmx.gluon.nn, name)(prefix="l_", **kw)
    jnet.initialize()
    tnet.initialize(ctx=tmx.cpu())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet(tmx.nd.array(x))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert sorted(tp.keys()) == sorted(jp.keys())
    for k in jp.keys():
        assert tp[k].shape == jp[k].shape, k
        tp[k].set_data(tmx.nd.array(jp[k].data().asnumpy()))
    got = tnet(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL5)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

INITS = {
    "orthogonal": ({}, (4, 2, 3)),
    "orthogonal_normal": ({"rand_type": "normal", "scale": 0.5}, (6, 4)),
    "msraprelu": ({"factor_type": "in", "slope": 0.1}, (5, 3, 2, 2)),
    "bilinear": ({}, (3, 2, 4, 4)),
    "lstmbias": ({"forget_bias": 2.0}, (8,)),
    "fusedrnn": ({"num_hidden": 3, "num_layers": 2}, (40,)),
}


@pytest.mark.parametrize("case", sorted(INITS) + ["mixed"])
def test_initializer_bytes(case):
    def init_of(pkg):
        if case == "mixed":
            return pkg.init.Mixed(["^a", ".*"],
                                  [pkg.init.Orthogonal(),
                                   pkg.init.create("msraprelu")])
        kw, _ = INITS[case]
        return pkg.init.create(case.split("_")[0], **kw)

    shape = INITS.get(case, ({}, (6, 5)))[1]
    for name in ("a_weight", "b_weight") if case == "mixed" else ("w_weight",):
        np.random.seed(11)
        want = jmx.nd.zeros(shape)
        init_of(jmx)(name, want)
        np.random.seed(11)
        got = torch.zeros(shape)
        init_of(tmx)(name, got)
        assert got.numpy().tobytes() == want.asnumpy().tobytes(), name
    if case != "mixed":
        assert init_of(tmx).dumps() == init_of(jmx).dumps()
