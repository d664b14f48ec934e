"""PyTorch port: ``gluon.rnn`` (the fused ``RNN``/``LSTM``/``GRU`` layers and
the cells) and the Gluon word language model against the JAX package's.

- The layers (TNC and NTC, two layers, bidirectional, with and without
  begin states, deferred input size): outputs, new states and the
  gradients of the input and the flat parameter blob at rtol 1e-5 (the
  blob's own ``init="uniform"``: a global Xavier never reaches it).
  Inter-layer dropout draws its key from the stream: under the same
  ``mx.random.seed`` the training outputs agree.
- The cells unrolled (a ``SequentialRNNCell`` of ``LSTMCell``,
  ``DropoutCell``, ``ResidualCell(GRUCell)`` and ``RNNCell``, unmerged
  with ``valid_length``; a ``BidirectionalCell`` of a ``ZoneoutCell``
  (``LSTMCell``) and a ``GRUCell``, merged, training under the same random
  stream): outputs, states and the input's gradient.
- ``example/gluon/word_language_model/train.py``'s ``RNNModel`` (vocab 50,
  hidden 16, one layer, bptt 5, dropout 0.2) trained three truncated-BPTT
  steps with ``clip_global_norm`` and ``Trainer("sgd")`` from the same
  weights and the same random stream: losses and parameters at rtol 1e-4; parameter files
  load across packages.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _copy_params(jnet, tnet):
    """The reference's initialized values into the port's block."""
    tmx.gluon.params_from_jax(tnet, {n: p.data().asnumpy() for n, p in
                                     jnet.collect_params().items()})


def _run(pkg, net, x, states, ct, train=False):
    """(outputs, new states, input gradient, parameter gradients)."""
    xa = pkg.nd.array(x)
    xa.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = net(xa, *([[pkg.nd.array(s) for s in states]] if states
                        else []))
        o = out[0] if isinstance(out, tuple) else out
        loss = (o * pkg.nd.array(ct)).sum()
    loss.backward()
    new = [s.asnumpy() for s in out[1]] if isinstance(out, tuple) else []
    grads = {n.split("_", 1)[1]: p.grad().asnumpy()
             for n, p in net.collect_params().items()}
    return o.asnumpy(), new, xa.grad.asnumpy(), grads


@pytest.mark.parametrize("kind,layout,bi,states", [
    ("LSTM", "TNC", True, True), ("GRU", "NTC", False, False),
    ("RNN", "TNC", True, True)])
def test_fused_layers_match_reference(kind, layout, bi, states):
    rs = np.random.RandomState(0)
    T, N, I, H = 4, 3, 5, 6
    x = rs.randn(*((T, N, I) if layout == "TNC" else (N, T, I))).astype(
        np.float32)
    nets = []
    for pkg in (jmx, tmx):
        net = getattr(pkg.gluon.rnn, kind)(H, num_layers=2, layout=layout,
                                           bidirectional=bi, prefix="r_")
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        nets.append(net)
    jnet, tnet = nets
    jnet(jmx.nd.array(x))   # deferred input size
    tnet(tmx.nd.array(x))
    assert tnet.parameters.shape == jnet.parameters.shape
    # the blob took its own uniform init, not the global Xavier
    blob = tnet.parameters.data().asnumpy()
    assert np.abs(blob).max() <= 0.07 and blob.std() > 0.03
    _copy_params(jnet, tnet)
    n_states = 2 if kind == "LSTM" else 1
    st = [rs.randn(2 * (1 + bi), N, H).astype(np.float32)
          for _ in range(n_states)] if states else None
    if states:
        jbegin = jnet.begin_state(batch_size=N)
        assert [tuple(s.shape) for s in tnet.begin_state(batch_size=N)] == \
            [tuple(s.shape) for s in jbegin]
    ct = rs.randn(*(x.shape[:2] + (H * (1 + bi),))).astype(np.float32)
    jres = _run(jmx, jnet, x, st, ct)
    tres = _run(tmx, tnet, x, st, ct)
    for a, b in zip(tres[:3], jres[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
    assert sorted(tres[3]) == sorted(jres[3])
    for n in jres[3]:
        np.testing.assert_allclose(tres[3][n], jres[3][n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_layer_dropout_follows_the_stream():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 3, 5).astype(np.float32)
    outs = []
    for pkg in (jmx, tmx):
        net = pkg.gluon.rnn.LSTM(6, num_layers=2, dropout=0.5, prefix="d_")
        net.initialize(ctx=pkg.cpu())
        net(pkg.nd.array(x))
        outs.append(net)
    _copy_params(*outs)
    res = []
    for pkg, net in zip((jmx, tmx), outs):
        pkg.random.seed(11)
        with pkg.autograd.record():
            a = net(pkg.nd.array(x)).asnumpy()
            b = net(pkg.nd.array(x)).asnumpy()
        res.append((a, b, net(pkg.nd.array(x)).asnumpy()))
    (ja, jb, jinf), (ta, tb, tinf) = res
    np.testing.assert_allclose(ta, ja, **TOL)
    np.testing.assert_allclose(tb, jb, **TOL)
    np.testing.assert_allclose(tinf, jinf, **TOL)
    assert not np.allclose(ta, tb)


def _cell(pkg, kind):
    r = pkg.gluon.rnn
    if kind == "stack":
        s = r.SequentialRNNCell(prefix="c_")
        with s.name_scope():
            s.add(r.LSTMCell(4, prefix="a_"))
            s.add(r.DropoutCell(0.0))
            s.add(r.ResidualCell(r.GRUCell(4, prefix="b_")))
            s.add(r.RNNCell(4, activation="relu", prefix="c_"))
        return s
    if kind == "bidir":
        return r.BidirectionalCell(
            r.ZoneoutCell(r.LSTMCell(3, prefix="c_l_"), zoneout_outputs=0.3,
                          zoneout_states=0.3),
            r.GRUCell(3, prefix="c_r_"), prefix="c_")
    raise ValueError(kind)


@pytest.mark.parametrize("kind,merge,valid", [("stack", False, True),
                                              ("bidir", True, False)])
def test_cells_unroll_match_reference(kind, merge, valid):
    rs = np.random.RandomState(2)
    x = rs.randn(3, 4, 4).astype(np.float32)      # NTC
    vl = np.array([4, 2, 3], np.float32) if valid else None
    cells = []
    for pkg in (jmx, tmx):
        cell = _cell(pkg, kind)
        cell.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        cell.unroll(4, pkg.nd.array(x), layout="NTC", merge_outputs=True)
        cells.append(cell)
    _copy_params(*cells)
    res = []
    for pkg, cell in zip((jmx, tmx), cells):
        pkg.random.seed(3)
        xa = pkg.nd.array(x)
        xa.attach_grad()
        cell.reset()
        with pkg.autograd.record():
            outs, states = cell.unroll(
                4, xa, layout="NTC", merge_outputs=merge,
                valid_length=None if vl is None else pkg.nd.array(vl))
            stacked = outs if merge else pkg.nd.stack(*outs, axis=1)
            loss = (stacked * stacked).sum() + sum(
                (s * s).sum() for s in states)
        loss.backward()
        res.append((stacked.asnumpy(), [s.asnumpy() for s in states],
                    xa.grad.asnumpy()))
    (jo, js, jg), (to, ts, tg) = res
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


def _example(pkg):
    """``train.py``'s namespace, built against ``pkg``."""
    path = os.path.join(ROOT, "example/gluon/word_language_model/train.py")
    with open(path) as f:
        src = f.read()
    if pkg is tmx:
        src = src.replace("import mxnet_tpu as mx",
                          "import mxnet_tpu_torch as mx")
        src = src.replace("from mxnet_tpu import", "from mxnet_tpu_torch import")
        src = src.replace("from mxnet_tpu.gluon import",
                          "from mxnet_tpu_torch.gluon import")
    ns = {"__name__": "word_lm_example", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


def _lm_steps(pkg, ns, tokens, weights, steps=3, bptt=5, batch=4):
    model = ns["RNNModel"](50, 16, 16, 1, dropout=0.2, prefix="lm_")
    model.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    data = ns["batchify"](tokens, batch)
    hidden = model.begin_state(func=pkg.nd.zeros, batch_size=batch)
    model(data[0:bptt], hidden)     # deferred shapes
    if weights is not None:
        if pkg is tmx:
            tmx.gluon.params_from_jax(model, weights)
        else:
            for n, p in model.collect_params().items():
                p.set_data(pkg.nd.array(weights[n]))
    weights = {n: p.data().asnumpy()
               for n, p in model.collect_params().items()}
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 1.0, "momentum": 0,
                                 "wd": 0})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    pkg.random.seed(5)
    losses = []
    for i in range(0, steps * bptt, bptt):
        X = data[i:i + bptt]
        y = data[i + 1:i + 1 + bptt].reshape((-1,))
        hidden = ns["detach"](hidden)
        with pkg.autograd.record():
            out, hidden = model(X, hidden)
            L = loss_fn(out, y)
        L.backward()
        grads = [p.grad() for p in model.collect_params().values()
                 if p.grad_req != "null"]
        pkg.gluon.utils.clip_global_norm(grads, 0.2 * bptt * batch)
        trainer.step(bptt * batch)
        losses.append(float(L.mean().asnumpy()))
    return model, weights, losses


def test_word_language_model_matches_reference(tmp_path):
    jns, tns = _example(jmx), _example(tmx)
    tokens, vocab = jns["get_stream"](num_tokens=200, vocab_size=50, seed=0)
    assert tns["get_stream"](num_tokens=200, vocab_size=50, seed=0) == \
        (tokens, vocab)
    jmodel, weights, jloss = _lm_steps(jmx, jns, tokens, None)
    tmodel, _, tloss = _lm_steps(tmx, tns, tokens, weights)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    jp = {n[3:]: p.data().asnumpy()
          for n, p in jmodel.collect_params().items()}
    tp = {n[3:]: p.data().asnumpy()
          for n, p in tmodel.collect_params().items()}
    assert sorted(tp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    # parameter files load across packages
    tfile, jfile = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tmodel.save_parameters(tfile)
    jmodel.save_parameters(jfile)
    jmodel.load_parameters(tfile)
    tmodel.load_parameters(jfile)
    for n, p in jmodel.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), tp[n[3:]])
    for n, p in tmodel.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), jp[n[3:]])
