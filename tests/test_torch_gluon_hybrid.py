"""PyTorch port: ``hybridize()``, ``net.cast`` with multi-precision bf16,
``export``/``SymbolBlock`` and ``Dropout`` under ``Module`` against the
JAX package's.

The net: a small channels-last check net (conv + BatchNorm + relu units,
a concat fan-out with asymmetric 1x3/3x1 kernels and a padded
``AvgPool2D(3, 1, 1)`` branch, ``MaxPool2D``, ``Dropout(0.3)``,
``Dense(5)``), B = 4 at 8x8, its parameters from the reference's Xavier
draw (``params_from_jax``), trained by ``gluon.Trainer(..., "sgd",
{"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})`` with
``SoftmaxCrossEntropyLoss`` for three steps on one batch, from one seed.
Hybridized (the port runs the captured program's pure function
uncaptured on the CPU) and eager, the masks are equal bit for bit (each
call's key schedule is the reference's) and the losses, weights and
running statistics agree within rtol 1e-4 (atol 1e-5).  The stream ends
at the same key.

bf16 (``cast("bfloat16")``, ``multi_precision``): the two packages round
bf16 convolutions in different orders.  Measured floor over five data
seeds: the training logits of the cast net differ by up to 1.3% of their
largest magnitude, a per-sample bf16 loss by 1.4% (3 bf16 ulps), and
after one step a bf16 weight (conv, Dense) differs from the reference's
by up to 15.5% of that step's update, normwise; a BatchNorm gamma or
beta (f32, updated by small gradients summed from bf16 terms) by up to
52%.  Held to: logits within 2**-5 of the largest magnitude, losses rtol
2**-5, bf16 weights within 25% of their update normwise and BatchNorm's
within 75%, masters f32 and weights bf16 (BatchNorm's stay f32, as the
reference casts them).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

B, HW, CLASSES = 4, 8, 5
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


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


def _build(mx, prefix="chk_", layout="NHWC", rate=0.3):
    nn = mx.gluon.nn
    ax = -1 if layout == "NHWC" else 1

    def unit(ch, k, p=0):
        u = nn.HybridSequential(prefix="")
        u.add(nn.Conv2D(ch, k, 1, p, use_bias=False, layout=layout),
              nn.BatchNorm(axis=ax, epsilon=1e-3), nn.Activation("relu"))
        return u

    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(unit(8, 3, 1))
        cat = nn.HybridConcatenate(axis=ax)
        b2 = nn.HybridSequential(prefix="")
        b2.add(unit(4, 1), unit(4, (1, 3), (0, 1)), unit(6, (3, 1), (1, 0)))
        b3 = nn.HybridSequential(prefix="")
        b3.add(nn.AvgPool2D(3, 1, 1, layout=layout), unit(4, 1))
        cat.add(unit(6, 1), b2, b3)
        net.add(cat, nn.MaxPool2D(2, 2, layout=layout), nn.Dropout(rate),
                nn.Flatten(), nn.Dense(CLASSES))
    return net


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, CLASSES, size=(B,)).astype(np.float32)
    return x, y


def _pair(x, resolve=True):
    """The same net in both packages, the port's weights the
    reference's; shapes resolved by one eager forward unless not
    ``resolve`` (then both nets get the reference's draw at their first
    call)."""
    a, b = _build(jmx), _build(tmx)
    jmx.random.seed(0)
    a.initialize(jmx.init.Xavier(magnitude=2))
    b.initialize(ctx="cpu")
    if resolve:
        a(jmx.nd.array(x))
        b(tmx.nd.array(x))
        tmx.gluon.params_from_jax(b, {k: p.data().asnumpy() for k, p in
                                      a.collect_params().items()})
    return a, b


def _params(net, cast=False):
    out = {}
    for k, p in net.collect_params().items():
        d = p.data()
        if cast:
            d = d.astype("float32")
        out[k[len(net.prefix):]] = d.asnumpy()
    return out


def _train(mx, net, x, y, steps, dtype="float32", opt=OPT):
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, outs = [], []
    for _ in range(steps):
        with mx.autograd.record():
            out = net(mx.nd.array(x, dtype=dtype))
            L = lf(out, mx.nd.array(y))
        L.backward()
        tr.step(x.shape[0])
        losses.append(L.astype("float32").asnumpy())
        outs.append(out.astype("float32").asnumpy())
    return losses, outs, tr


@pytest.mark.parametrize("hybrid", [True, False])
def test_train_f32_matches_reference(hybrid):
    x, y = _data()
    a, b = _pair(x)
    if hybrid:
        a.hybridize()
        b.hybridize()
    jmx.random.seed(3)
    tmx.random.seed(3)
    la, oa, _ = _train(jmx, a, x, y, 3)
    lb, ob, _ = _train(tmx, b, x, y, 3)
    for u, v in zip(oa, ob):
        # the Dropout before the head zeroes the same features: the
        # logits' pattern can't show it, so compare the values closely
        np.testing.assert_allclose(v, u, rtol=1e-4, atol=1e-5)
    for u, v in zip(la, lb):
        np.testing.assert_allclose(v, u, rtol=1e-4, atol=1e-5)
    pa, pb = _params(a), _params(b)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tmx.random.get_state(),
                                  jmx.random.get_state())
    if hybrid:
        assert len(b._cached_ops) == 1


def test_hybrid_masks_bitwise():
    """The masks a hybridized call draws (the call's key split by every
    active child block in turn) are the reference's, and differ from an
    eager call's: a net of one Dropout after a Dense, on ones."""
    outs = {}
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential(prefix="m_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(64, in_units=16, use_bias=False,
                                      weight_initializer="ones"),
                    mx.gluon.nn.Dropout(0.5))
        net.initialize(**({"ctx": "cpu"} if mx is tmx else {}))
        x = mx.nd.ones((8, 16))
        mx.random.seed(4)
        with mx.autograd.record():
            eager = net(x).asnumpy()
        net.hybridize()
        with mx.autograd.record():
            hyb = [net(x).asnumpy() for _ in range(2)]
        outs[mx.__name__] = (eager, hyb)
    (ea, ha), (eb, hb) = outs["mxnet_tpu"], outs["mxnet_tpu_torch"]
    np.testing.assert_array_equal(ea, eb)
    for u, v in zip(ha, hb):
        np.testing.assert_array_equal(u, v)
    assert not np.array_equal(eb != 0, hb[0] != 0)
    assert not np.array_equal(hb[0] != 0, hb[1] != 0)


def test_hybridize_before_first_call_matches_reference():
    """Deferred shapes resolve in an eager forward whose active children
    run their own programs (each drawing its key), then the program runs:
    the reference's order, so the stream stays in step."""
    x, _ = _data(1)
    a, b = _pair(x, resolve=False)
    a.hybridize()
    b.hybridize()
    jmx.random.seed(5)
    tmx.random.seed(5)
    with jmx.autograd.record():
        oa = a(jmx.nd.array(x)).asnumpy()
    with tmx.autograd.record():
        ob = b(tmx.nd.array(x)).asnumpy()
    assert oa.shape == ob.shape == (B, CLASSES)
    np.testing.assert_array_equal(tmx.random.get_state(),
                                  jmx.random.get_state())


def test_bf16_cast_multi_precision():
    x, y = _data()
    a, b = _pair(x)
    p0 = _params(a)
    for net in (a, b):
        net.cast("bfloat16")
        net.hybridize()
    dt = {k: str(p.data().dtype) for k, p in b.collect_params().items()}
    assert dt["chk_conv2d0_weight"] == "bfloat16"
    assert dt["chk_batchnorm0_gamma"] == "float32"
    assert dt["chk_batchnorm0_running_var"] == "float32"
    opt = dict(OPT, multi_precision=True)
    jmx.random.seed(3)
    tmx.random.seed(3)
    la, oa, _ = _train(jmx, a, x, y, 1, "bfloat16", opt)
    lb, ob, tr = _train(tmx, b, x, y, 1, "bfloat16", opt)
    scale = np.abs(oa[0]).max()
    assert np.abs(ob[0] - oa[0]).max() <= 2 ** -5 * scale
    np.testing.assert_allclose(lb[0], la[0], rtol=2 ** -5)
    pa, pb = _params(a, True), _params(b, True)
    for k in pa:
        upd = np.linalg.norm(pa[k] - p0[k])
        tol = 0.75 if "batchnorm" in k else 0.25
        assert np.linalg.norm(pb[k] - pa[k]) <= tol * upd, k
    w = b.collect_params()["chk_conv2d0_weight"]
    states = tr._updaters[0].states
    masters = [s[0] for s in states.values()
               if isinstance(s, tuple) and hasattr(s[0], "_data")]
    assert masters and all(m._data.dtype == torch.float32 for m in masters)
    assert w.data()._data.dtype == torch.bfloat16


def test_cache_rules():
    x, y = _data()
    _, b = _pair(x)
    b.hybridize()
    b(tmx.nd.array(x))
    assert len(b._cached_ops) == 1
    b(tmx.nd.array(x))
    assert len(b._cached_ops) == 1                  # replayed
    b(tmx.nd.array(np.concatenate([x, x])))
    assert len(b._cached_ops) == 2                  # a new shape
    with tmx.autograd.record():
        b(tmx.nd.array(x))
    assert len(b._cached_ops) == 3                  # training: its own
    keys = {k[1] for k in b._cached_ops}
    assert keys == {False, True}
    b.hybridize()
    assert len(b._cached_ops) == 0                  # hybridize drops
    b(tmx.nd.array(x))
    b.cast("float64")
    assert len(b._cached_ops) == 0                  # cast drops
    b.cast("float32")
    b(tmx.nd.array(x))
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"hyb_cache_{os.getpid()}.params")
    try:
        b.save_parameters(path)
        b.load_parameters(path)
        assert len(b._cached_ops) == 0              # load drops
    finally:
        os.remove(path)
    # a parameter rebound (not through cast) makes its program stale
    out = b(tmx.nd.array(x))
    prog = next(iter(b._cached_ops.values()))
    p = b.collect_params()["chk_dense0_bias"]
    p.initialize(ctx="cpu", force_reinit=True)
    p.set_data(torch.ones(CLASSES))
    assert prog.stale()
    again = b(tmx.nd.array(x))
    assert next(iter(b._cached_ops.values())) is not prog
    np.testing.assert_allclose(again.asnumpy(), out.asnumpy() + 1,
                               rtol=1e-5, atol=1e-5)


def test_kwargs_run_eagerly():
    class Scaled(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, scale=1.0):
            return x * scale

    blk = Scaled()
    blk.hybridize()
    x = tmx.nd.array(np.ones((2, 3)))
    assert blk(x, scale=3.0).asnumpy().sum() == 18.0
    assert len(blk._cached_ops) == 0
    assert blk(x).asnumpy().sum() == 6.0
    assert len(blk._cached_ops) == 1


def test_load_parameters_seen_by_hybridized_net(tmp_path):
    x, _ = _data()
    _, b = _pair(x)
    other = _build(tmx, prefix="chk_")
    other.initialize(ctx="cpu", init=tmx.init.Xavier(magnitude=2))
    other(tmx.nd.array(x))
    b.hybridize()
    before = b(tmx.nd.array(x)).asnumpy()
    other.save_parameters(str(tmp_path / "o.params"))
    b.load_parameters(str(tmp_path / "o.params"))
    after = b(tmx.nd.array(x)).asnumpy()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, other(tmx.nd.array(x)).asnumpy())


def test_export_bytes_and_symbolblock(tmp_path):
    x, _ = _data()
    with jmx.name.NameManager():
        a = _build(jmx)
    with tmx.name.NameManager():
        b = _build(tmx)
    a.initialize(jmx.init.Xavier(magnitude=2))
    b.initialize(ctx="cpu")
    a(jmx.nd.array(x))
    b(tmx.nd.array(x))
    tmx.gluon.params_from_jax(b, {k: p.data().asnumpy() for k, p in
                                  a.collect_params().items()})
    a.hybridize()
    b.hybridize()
    ref = b(tmx.nd.array(x)).asnumpy()
    with jmx.name.NameManager():
        a.export(str(tmp_path / "a"))
    with tmx.name.NameManager():
        b.export(str(tmp_path / "b"))
    for suffix in ("-symbol.json", "-0000.params"):
        assert (tmp_path / ("a" + suffix)).read_bytes() == \
            (tmp_path / ("b" + suffix)).read_bytes()
    blk = tmx.gluon.SymbolBlock.imports(str(tmp_path / "a-symbol.json"),
                                        ["data"],
                                        str(tmp_path / "a-0000.params"),
                                        ctx="cpu")
    jblk = jmx.gluon.SymbolBlock.imports(str(tmp_path / "b-symbol.json"),
                                         ["data"],
                                         str(tmp_path / "b-0000.params"))
    got = blk(tmx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, ref)
    blk.hybridize()     # the graph's random node keyed inside a program
    np.testing.assert_array_equal(blk(tmx.nd.array(x)).asnumpy(), ref)
    with tmx.autograd.record():
        assert blk(tmx.nd.array(x)).shape == ref.shape
    np.testing.assert_allclose(got, jblk(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-4, atol=1e-5)
    assert sorted(blk.collect_params()) == sorted(jblk.collect_params())


def test_hooks_apply_summary(capsys):
    net = _build(tmx, prefix="hk_")
    net.initialize(ctx="cpu")
    seen = []
    net.register_forward_pre_hook(lambda blk, args: seen.append("pre"))
    net.register_forward_hook(
        lambda blk, args, out: seen.append(type(out).__name__))
    net(tmx.nd.array(_data()[0]))
    assert seen == ["pre", "NDArray"]
    names = []
    net.apply(lambda blk: names.append(blk.name))
    assert names[-1] == "hk" and len(names) > 20
    net.summary()
    assert "HybridSequential" in capsys.readouterr().out


def test_dropout_symbol_under_module():
    """A ``Dropout`` node under ``Module``: one key per forward, each
    node's ``fold_in(key, uid)``; with the two graphs' uids equal, the
    forward outputs and one SGD update match the reference's."""
    rs = np.random.RandomState(2)
    X = rs.randn(8, 10).astype(np.float32)
    Y = rs.randint(0, 3, size=(8,)).astype(np.float32)
    w = {"fc1_weight": rs.randn(16, 10).astype(np.float32) * 0.3,
         "fc1_bias": np.zeros(16, np.float32),
         "fc2_weight": rs.randn(3, 16).astype(np.float32) * 0.3,
         "fc2_bias": np.zeros(3, np.float32)}
    syms = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            d = mx.sym.var("data")
            h = mx.sym.Activation(mx.sym.FullyConnected(d, num_hidden=16,
                                                        name="fc1"),
                                  act_type="relu", name="relu1")
            h = mx.sym.Dropout(h, p=0.5, name="drop")
            out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                h, num_hidden=3, name="fc2"), name="softmax")
        syms.append(out)
    jn = {n.name: n for n in __import__(
        "mxnet_tpu.symbol.graph", fromlist=["x"]).topo_order(
            syms[0]._entries)}
    for n in __import__("mxnet_tpu_torch.symbol.graph",
                        fromlist=["x"]).topo_order(syms[1]._entries):
        n._uid = jn[n.name]._uid
    res = []
    for mx, sym, ctx in ((jmx, syms[0], jmx.cpu()),
                         (tmx, syms[1], tmx.cpu())):
        mx.random.seed(12)
        it = mx.io.NDArrayIter(X, Y, batch_size=8)
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v) for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = next(iter(it))
        mod.forward(batch, is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
        args, _ = mod.get_params()
        res.append((out, {k: v.asnumpy() for k, v in args.items()},
                    mx.random.get_state()))
    (oa, pa, ka), (ob, pb, kb) = res
    np.testing.assert_allclose(ob, oa, rtol=1e-5, atol=1e-6)
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ka, kb)
