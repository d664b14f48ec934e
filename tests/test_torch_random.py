"""PyTorch port: the random stream and the random ops against the JAX
package's.

The stream (``mx.random``: ``seed``, ``next_key``, ``fold_in``,
``get_state``/``set_state``, the main thread's base key and a worker
thread's ``fold_in(base, first-touch index)``) is held bit for bit.  So
are ``uniform`` (also over a shifted range: XLA fuses its multiply-add,
emulated in float64 by the port), ``randint`` and ``Dropout``'s masks,
eager, with ``axes`` and with ``mode="always"`` in inference, and the
number of keys each call draws (one per random op, in inference too).
``Dropout``'s values are ``data * mask / keep``; XLA:CPU divides by a
constant as a multiply by its reciprocal, so kept values agree within 1
ulp.  ``normal`` goes through ``erfinv``, which torch and XLA round
differently near +-1: within 128 ulps (the largest measured over 2e5
draws is 90, near 3.8 sigma), and ``exponential`` within 2 ulps
(``log1p``).  The samplers that need a rejection loop or a sort raise
``MXNetError`` naming ROADMAP Queue 1 item 2.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _seed(s):
    jmx.random.seed(s)
    tmx.random.seed(s)


def test_stream_keys_and_state():
    _seed(11)
    for _ in range(4):
        want = np.asarray(jmx.random.next_key())
        np.testing.assert_array_equal(tmx.random.next_key(), want)
    np.testing.assert_array_equal(np.asarray(jmx.random.fold_in(5)),
                                  tmx.random.fold_in(5))
    state = tmx.random.get_state()
    np.testing.assert_array_equal(state, jmx.random.get_state())
    a = [tmx.random.next_key() for _ in range(3)]
    tmx.random.set_state(state)
    jmx.random.set_state(state)
    b = [tmx.random.next_key() for _ in range(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(jmx.random.next_key()), b[0])
    # PRNGKey and split are JAX's
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(tmx.random.prng_key(7), np.asarray(key))
    for i in range(2):
        np.testing.assert_array_equal(
            tmx.random.split(np.asarray(key), i),
            np.asarray(jax.random.split(key)[i]))


def test_worker_thread_stream_and_reseed():
    _seed(3)
    got = {}

    def worker():
        got["t"] = [tmx.random.next_key() for _ in range(2)]
        got["t_seq"] = tmx.random._state.seq
        got["j"] = [np.asarray(jmx.random.next_key()) for _ in range(2)]
        got["j_seq"] = jmx.random._state.seq

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    for pkg, seq in (("t", got["t_seq"]), ("j", got["j_seq"])):
        key = jax.random.fold_in(jax.random.PRNGKey(3), seq)
        want = []
        for _ in range(2):
            key, sub = jax.random.split(key)
            want.append(np.asarray(sub))
        for g, w in zip(got[pkg], want):
            np.testing.assert_array_equal(g, w)
    # the main thread keeps the base key itself
    np.testing.assert_array_equal(
        tmx.random.next_key(),
        np.asarray(jax.random.split(jax.random.PRNGKey(3))[1]))
    # seed() makes every thread re-derive its key at its next draw
    box = {}
    ready, go = threading.Event(), threading.Event()

    def holder():
        box["before"] = tmx.random.next_key()
        ready.set()
        go.wait()
        box["after"] = tmx.random.next_key()
        box["seq"] = tmx.random._state.seq

    th = threading.Thread(target=holder)
    th.start()
    ready.wait()
    tmx.random.seed(99)
    go.set()
    th.join()
    base = jax.random.fold_in(jax.random.PRNGKey(99), box["seq"])
    np.testing.assert_array_equal(box["after"],
                                  np.asarray(jax.random.split(base)[1]))


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0),
                                      (-1e-3, 7.3)])
def test_uniform_bitwise(low, high):
    _seed(5)
    a = jmx.nd.random.uniform(low, high, shape=(4096,)).asnumpy()
    b = tmx.nd.random.uniform(low, high, shape=(4096,)).asnumpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    c = tmx.random.uniform(low, high, shape=(3, 5))   # mx.random.* too
    d = jmx.random.uniform(low, high, shape=(3, 5))
    np.testing.assert_array_equal(c.asnumpy(), d.asnumpy())


@pytest.mark.parametrize("low,high", [(0, 10), (-5, 7), (0, 70000),
                                      (0, 2 ** 31 - 1),
                                      (-2 ** 31, 2 ** 31 - 1), (3, 3)])
def test_randint_bitwise(low, high):
    _seed(6)
    a = jmx.nd.random.randint(low, high, shape=(2000,)).asnumpy()
    b = tmx.nd.random.randint(low, high, shape=(2000,)).asnumpy()
    assert b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_normal_and_exponential_ulps():
    _seed(8)
    a = jmx.nd.random.normal(shape=(20000,)).asnumpy()
    b = tmx.nd.random.normal(shape=(20000,)).asnumpy()
    assert _ulps(a, b).max() <= 128
    a = jmx.nd.random.normal(2.0, 3.0, shape=(100,)).asnumpy()
    b = tmx.nd.random.normal(2.0, 3.0, shape=(100,)).asnumpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    a = jmx.nd.random.exponential(2.0, shape=(20000,)).asnumpy()
    b = tmx.nd.random.exponential(2.0, shape=(20000,)).asnumpy()
    assert _ulps(a, b).max() <= 2
    a = jmx.random.randn(2, 3).asnumpy()
    b = tmx.random.randn(2, 3).asnumpy()
    assert b.shape == (2, 3) and _ulps(a, b).max() <= 128


@pytest.mark.parametrize("axes,record,mode", [
    ((), True, "training"), ((1,), True, "training"),
    ((0, 2), True, "training"), ((), False, "always"),
    ((), False, "training")])
def test_dropout_masks(axes, record, mode):
    _seed(9)
    x = np.random.RandomState(0).randn(4, 6, 5).astype(np.float32) + 3.0
    outs = []
    for mx in (jmx, tmx):
        with mx.autograd.record(train_mode=record):
            outs.append(mx.nd.Dropout(mx.nd.array(x), p=0.3, axes=axes,
                                      mode=mode).asnumpy())
    a, b = outs
    np.testing.assert_array_equal(a != 0, b != 0)
    assert _ulps(a, b).max() <= 1
    if not record and mode == "training":
        np.testing.assert_array_equal(b, x)
    for ax in axes:   # the mask broadcasts along axes
        m = b != 0
        assert (m == m.take([0], axis=ax)).all()
    # every call draws one key, in inference too
    np.testing.assert_array_equal(tmx.random.get_state(),
                                  jmx.random.get_state())


def test_dropout_tensor_path_and_kept_fraction():
    """The op namespace on plain tensors (a block's forward) draws its key
    from the stream too; the kept fraction is binomial."""
    _seed(10)
    x = torch.ones(200000)
    out = tmx.nd.Dropout(x, p=0.25, _training=True)
    with jmx.autograd.record():
        ref = jmx.nd.Dropout(jmx.nd.ones((200000,)), p=0.25).asnumpy()
    np.testing.assert_array_equal(out.numpy() != 0, ref != 0)
    kept = int((out != 0).sum())
    sd = (200000 * 0.25 * 0.75) ** 0.5
    assert abs(kept - 150000) < 5 * sd


@pytest.mark.parametrize("fn,args", [
    ("gamma", {}), ("poisson", {}), ("negative_binomial", {}),
    ("generalized_negative_binomial", {})])
def test_rejection_samplers_refused(fn, args):
    with pytest.raises(tmx.MXNetError, match="Queue 1, item 2"):
        getattr(tmx.nd.random, fn)(shape=(3,), **args)


def test_sort_samplers_refused_and_dtypes():
    with pytest.raises(tmx.MXNetError, match="Queue 1, item 2"):
        tmx.nd.random.shuffle(tmx.nd.array(np.arange(4.0)))
    with pytest.raises(tmx.MXNetError, match="Queue 1, item 2"):
        tmx.nd.random.multinomial(tmx.nd.array(np.ones(4) / 4))
    with pytest.raises(tmx.MXNetError, match="float32"):
        tmx.nd.random.uniform(shape=(2,), dtype="float16")
    with pytest.raises(tmx.MXNetError, match="int32"):
        tmx.nd.random.randint(0, 4, shape=(2,), dtype="int64")


def test_symbol_dropout_keys():
    """A graph's random node takes ``fold_in(forward key, node uid)``:
    one ``Dropout`` node evaluated by each package's graph evaluator with
    the same key and uid gives the same mask."""
    from mxnet_tpu.symbol.graph import eval_node as j_eval
    from mxnet_tpu_torch.symbol.graph import eval_node as t_eval

    x = np.random.RandomState(1).randn(8, 16).astype(np.float32) + 2.0
    js = jmx.sym.Dropout(jmx.sym.var("data"), p=0.5)
    ts = tmx.sym.Dropout(tmx.sym.var("data"), p=0.5)
    jn, tn = js._entries[0].node, ts._entries[0].node
    tn._uid = jn._uid
    key = jax.random.PRNGKey(21)
    a = np.asarray(j_eval(jn, [jax.numpy.asarray(x)], True, key)[0])
    b = t_eval(tn, [torch.from_numpy(x)], True,
               rng=np.asarray(key))[0].numpy()
    np.testing.assert_array_equal(a != 0, b != 0)
    assert _ulps(a, b).max() <= 1
