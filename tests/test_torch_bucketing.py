"""PyTorch port: ``BucketingModule``, ``SequentialModule`` and ``Monitor``
against the JAX package's.

- ``BucketingModule.fit`` over ``lstm_bucketing.py``'s model (an
  ``Embedding``, two unrolled ``mx.rnn.LSTMCell``s, a ``FullyConnected``
  decoder and ``SoftmaxOutput``) at a small size, two buckets fed by
  ``BucketSentenceIter`` under the same ``random.seed``, Adam, from the
  same numpy ``arg_params``: every batch's loss and the final parameters
  at rtol 1e-4, the per-epoch perplexity too.  Both packages take the
  legacy route (``forward_backward`` + ``update``), and every bucket's
  module shares one ``Updater``.
- A bucket bound earlier forwards with the weights the current bucket
  just trained.
- ``SequentialModule`` (``take_labels``, ``auto_wiring``): a two-module
  chain's fit, outputs and parameters at rtol 1e-4.
- ``Monitor``: the rows ``toc`` returns (names, steps and stats).
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-4, atol=1e-6)
VOCAB, EMBED, HIDDEN, BATCH, BUCKETS = 12, 6, 8, 4, [4, 7]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def _pyrandom():
    state = random.getstate()
    yield
    random.setstate(state)


def _sentences(n=40, seed=0):
    rs = np.random.RandomState(seed)
    trans = rs.randint(1, VOCAB, size=(VOCAB, 2))
    out = []
    for _ in range(n):
        tok = int(rs.randint(1, VOCAB))
        sent = [tok]
        for _ in range(int(rs.randint(2, 7)) - 1):
            tok = int(trans[tok, rs.randint(2)])
            sent.append(tok)
        out.append(sent)
    return out


def _sym_gen(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(num_hidden=HIDDEN, prefix=f"lstm_l{i}_"))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=VOCAB,
                                  output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                      name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _arg_params(seed=1):
    rs = np.random.RandomState(seed)
    shapes = {"embed_weight": (VOCAB, EMBED), "pred_weight": (VOCAB, HIDDEN),
              "pred_bias": (VOCAB,)}
    for i in range(2):
        isz = EMBED if i == 0 else HIDDEN
        shapes.update({f"lstm_l{i}_i2h_weight": (4 * HIDDEN, isz),
                       f"lstm_l{i}_h2h_weight": (4 * HIDDEN, HIDDEN),
                       f"lstm_l{i}_i2h_bias": (4 * HIDDEN,),
                       f"lstm_l{i}_h2h_bias": (4 * HIDDEN,)})
    return {n: (0.3 * rs.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _ce(probs, labels):
    p = probs[np.arange(len(labels)), labels.astype(int)]
    keep = labels != 0
    return float(-np.log(np.maximum(p[keep], 1e-30)).mean())


def _fit(pkg, epochs=2):
    random.seed(3)
    it = pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    losses, ppl = [], []

    def record(label, pred):
        # each batch's loss, from the outputs of the bucket that ran it
        # (update_metric runs before fit prepares the next batch)
        losses.append((label.shape[1], _ce(pred, label.reshape(-1))))
        return 0.0

    def per_epoch(epoch, sym, arg, aux):
        ppl.append(perplexity.get()[1])

    perplexity = pkg.metric.Perplexity(ignore_label=0)
    metric = pkg.metric.CompositeEvalMetric([perplexity, pkg.metric.np(record)])
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=pkg.init.Xavier(factor_type="in", magnitude=2.34),
            arg_params={k: pkg.nd.array(v) for k, v in _arg_params().items()},
            num_epoch=epochs, epoch_end_callback=per_epoch)
    return mod, losses, ppl


def test_bucketing_fit_matches_reference(_pyrandom):
    jmod, jloss, jppl = _fit(jmx)
    tmod, tloss, tppl = _fit(tmx)
    assert [k for k, _ in tloss] == [k for k, _ in jloss]
    assert {k for k, _ in tloss} == set(BUCKETS)
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss],
                               **TOL)
    np.testing.assert_allclose(tppl, jppl, **TOL)
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg)
    for n in jarg:
        np.testing.assert_allclose(targ[n].asnumpy(), jarg[n].asnumpy(),
                                   **TOL, err_msg=n)
    # the reference's route: no bucket module took a fused step, and
    # every bucket's module shares the first one's Updater
    mods = list(tmod._buckets.values())
    assert sorted(tmod._buckets) == sorted(BUCKETS)
    assert all(m._fused_step_count == 0 for m in mods)
    assert len({id(m._updater) for m in mods}) == 1


def test_bucket_switch_sees_trained_weights(_pyrandom):
    tmod, _, _ = _fit(tmx, epochs=1)
    cur = tmod._curr_bucket_key
    other = next(k for k in BUCKETS if k != cur)
    trained = {n: v.asnumpy() for n, v in tmod.get_params()[0].items()}
    stale = tmod._buckets[other]._exec.arg_dict
    assert any(not np.array_equal(stale[n].asnumpy(), trained[n])
               for n in trained)
    rs = np.random.RandomState(4)
    x = rs.randint(1, VOCAB, size=(BATCH, other)).astype(np.float32)
    batch = tmx.io.DataBatch([tmx.nd.array(x)], [tmx.nd.array(x)],
                             bucket_key=other,
                             provide_data=[tmx.io.DataDesc("data", x.shape)],
                             provide_label=[tmx.io.DataDesc("softmax_label",
                                                            x.shape)])
    tmod.forward(batch, is_train=False)
    for n, v in trained.items():
        np.testing.assert_array_equal(stale[n].asnumpy(), v, err_msg=n)
    # the same forward from a module bound afresh with those weights
    sym = _sym_gen(tmx)(other)[0]
    fresh = tmx.mod.Module(sym, context=tmx.cpu())
    fresh.bind([("data", x.shape)], [("softmax_label", x.shape)],
               for_training=False)
    fresh.set_params({n: tmx.nd.array(v) for n, v in trained.items()}, {})
    fresh.forward(batch, is_train=False)
    np.testing.assert_array_equal(tmod.get_outputs()[0].asnumpy(),
                                  fresh.get_outputs()[0].asnumpy())


def _chain(pkg):
    with pkg.name.NameManager():
        d = pkg.sym.Variable("data")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(d, num_hidden=8,
                                                      name="fc1"),
                               act_type="tanh")
        d2 = pkg.sym.Variable("feat")
        out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            d2, num_hidden=3, name="fc2"), name="softmax")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(h, label_names=None, context=pkg.cpu()))
    seq.add(pkg.mod.Module(out, data_names=("feat",), context=pkg.cpu()),
            take_labels=True, auto_wiring=True)
    return seq


def test_sequential_module_matches_reference():
    rs = np.random.RandomState(0)
    X = rs.randn(24, 5).astype(np.float32)
    Y = rs.randint(0, 3, 24).astype(np.float32)
    w = {"fc1_weight": 0.4 * rs.randn(8, 5), "fc1_bias": 0.1 * rs.randn(8),
         "fc2_weight": 0.4 * rs.randn(3, 8), "fc2_bias": 0.1 * rs.randn(3)}
    res = []
    for pkg in (jmx, tmx):
        seq = _chain(pkg)
        it = pkg.io.NDArrayIter(X, Y, batch_size=8)
        seq.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                arg_params={k: pkg.nd.array(v.astype(np.float32))
                            for k, v in w.items()})
        arg, _ = seq.get_params()
        out = seq.predict(pkg.io.NDArrayIter(X, Y, batch_size=8))
        res.append(({k: v.asnumpy() for k, v in arg.items()},
                    out.asnumpy(), dict(seq.score(it, "acc"))))
    (ja, jo, js), (ta, to, ts) = res
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], **TOL, err_msg=k)
    np.testing.assert_allclose(to, jo, **TOL)
    assert ts == js


def test_monitor_stats():
    rs = np.random.RandomState(0)
    X = rs.randn(8, 5).astype(np.float32)
    w = {"fc1_weight": rs.randn(8, 5).astype(np.float32),
         "fc1_bias": rs.randn(8).astype(np.float32)}
    rows = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            h = pkg.sym.Activation(pkg.sym.FullyConnected(
                pkg.sym.Variable("data"), num_hidden=8, name="fc1"),
                act_type="tanh", name="act")
        mod = pkg.mod.Module(h, label_names=None, context=pkg.cpu())
        mod.bind([("data", X.shape)], for_training=False)
        mod.set_params({k: pkg.nd.array(v) for k, v in w.items()}, {})
        mon = pkg.monitor.Monitor(2, pattern="act.*", sort=True)
        mod.install_monitor(mon)
        got = []
        for step in range(3):
            mon.tic()
            mod.forward(pkg.io.DataBatch([pkg.nd.array(X * (step + 1))]),
                        is_train=False)
            got.append(mon.toc())
        rows.append(got)
    jrows, trows = rows
    assert [[(s, n) for s, n, _ in r] for r in trows] == \
        [[(s, n) for s, n, _ in r] for r in jrows]
    assert [len(r) for r in trows] == [2, 0, 2]
    for jr, tr in zip(jrows, trows):
        for (_, _, a), (_, _, b) in zip(tr, jr):
            np.testing.assert_allclose(a, b, rtol=1e-5)
