"""PyTorch port: the ``local`` and ``device`` kvstores against the JAX
package's.

The same numpy values (from a seed) go through ``init``, ``push`` (one
value and a list of per-device values, one key and a list of keys),
``pull`` and ``pushpull`` in both packages, with and without
``set_optimizer`` (SGD with momentum: the update on the store); results
agree to rtol 1e-6 / atol 1e-7 (sums of three float32 values, added in
the same order).  The store keeps values: a gradient buffer written after
``push`` leaves the stored value as it was.  The ``device`` store's 2-bit
compressed reduce (threshold 0.5, three rounds of error feedback) is
bit-exact against the reference's, whose pack and unpack Pallas kernels
run through the interpreter.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPE = (4, 6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _v(seed, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _equal(want, got, exact=False):
    w, g = want.asnumpy(), got.asnumpy()
    if exact:
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    else:
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", ["local", "device"])
def test_push_pull_replaces_and_sums(kind):
    outs = []
    for mx in (jmx, tmx):
        kv = mx.kvstore.create(kind)
        assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
        kv.init(3, mx.nd.array(_v(0)))
        kv.init([5, 7], [mx.nd.array(_v(1)), mx.nd.array(_v(2, (3,)))])
        got = []
        out = mx.nd.zeros(SHAPE)
        kv.pull(3, out=out)
        got.append(out)
        # one key, three per-device values: their sum replaces the value
        kv.push(3, [mx.nd.array(_v(10 + i)) for i in range(3)])
        out = mx.nd.zeros(SHAPE)
        kv.pull(3, out=out)
        got.append(out)
        # a list of keys, each pulled into two destinations
        kv.push([5, 7], [mx.nd.array(_v(20)), mx.nd.array(_v(21, (3,)))])
        o5 = [mx.nd.zeros(SHAPE), mx.nd.zeros(SHAPE)]
        o7 = mx.nd.zeros((3,))
        kv.pull([5, 7], out=[o5, o7])
        got += o5 + [o7]
        o = mx.nd.zeros(SHAPE)
        kv.pushpull(5, mx.nd.array(_v(30)), out=o)
        got.append(o)
        outs.append(got)
    for want, got in zip(*outs):
        _equal(want, got)


@pytest.mark.parametrize("kind", ["local", "device"])
def test_update_on_store(kind):
    """With set_optimizer the stored value is the weight: a push applies
    the update, a pull reads the weight."""
    outs = []
    for mx in (jmx, tmx):
        kv = mx.kvstore.create(kind)
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=0.01,
            rescale_grad=0.5))
        kv.init(0, mx.nd.array(_v(40)))
        got = []
        for step in range(3):
            kv.push(0, [mx.nd.array(_v(50 + step)),
                        mx.nd.array(_v(60 + step))])
            w = mx.nd.zeros(SHAPE)
            kv.pull(0, out=w)
            got.append(w)
        outs.append(got)
    for want, got in zip(*outs):
        _equal(want, got)


def test_store_holds_values_not_buffers():
    kv = tmx.kvstore.create("device")
    w = tmx.nd.array(_v(70))
    kv.init(0, w)
    w += 100.0               # the caller's buffer moves on
    g = tmx.nd.array(_v(71))
    kv.push(0, g)
    g[:] = 0.0               # the next backward overwrites the gradient
    g += 3.0
    out = tmx.nd.zeros(SHAPE)
    kv.pull(0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), _v(71))
    out += 1.0               # a pulled copy is the caller's own
    again = tmx.nd.zeros(SHAPE)
    kv.pull(0, out=again)
    np.testing.assert_array_equal(again.asnumpy(), _v(71))
    # list pushes and pulls copy too
    kv.init([1, 2], [tmx.nd.array(_v(72)), tmx.nd.array(_v(73))])
    gs = [tmx.nd.array(_v(74)), tmx.nd.array(_v(75))]
    kv.push([1, 2], gs)
    for x in gs:
        x[:] = -1.0
    outs = [tmx.nd.zeros(SHAPE), tmx.nd.zeros(SHAPE)]
    kv.pull([1, 2], out=outs)
    np.testing.assert_array_equal(outs[0].asnumpy(), _v(74))
    np.testing.assert_array_equal(outs[1].asnumpy(), _v(75))


def test_compressed_reduce_bit_exact():
    comp = {"type": "2bit", "threshold": 0.5}
    shapes = [SHAPE, (5000,), (3, 3, 3, 8)]
    outs, stores = [], []
    for mx in (jmx, tmx):
        kv = mx.kvstore.create("device")
        kv.set_gradient_compression(comp)
        kv.init(list(range(3)), [mx.nd.zeros(s) for s in shapes])
        got = []
        for step in range(3):
            for k, s in enumerate(shapes):
                kv.push(k, mx.nd.array(_v(80 + 10 * step + k, s) * 0.4))
                o = mx.nd.zeros(s)
                kv.pull(k, out=o)
                got.append(o)
        outs.append(got)
        stores.append(kv)
    for want, got in zip(*outs):
        _equal(want, got, exact=True)
    jres, tres = stores[0]._residuals, stores[1]._residuals
    assert sorted(jres) == sorted(tres)
    for key in jres:
        np.testing.assert_array_equal(
            tres[key].numpy().view(np.uint32),
            np.asarray(jres[key]).view(np.uint32))


def test_refusals():
    for name in ("dist_sync", "dist_async", "tpu_sync", "nccl"):
        with pytest.raises(MXNetError, match="Queue 1, item 5"):
            tmx.kvstore.create(name)
    kv = tmx.kvstore.create("local")
    with pytest.raises(MXNetError, match="local"):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv = tmx.kvstore.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, tmx.nd.zeros((4,), dtype="float16"))
    with pytest.raises(MXNetError, match="fp32"):
        kv.push(0, tmx.nd.ones((4,), dtype="float16"))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.pull(9, out=tmx.nd.zeros((4,)))


def test_optimizer_states_round_trip(tmp_path):
    kv = tmx.kvstore.create("device")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv.init(0, tmx.nd.array(_v(90)))
    kv.push(0, tmx.nd.array(_v(91)))
    f = str(tmp_path / "kv.states")
    kv.save_optimizer_states(f)
    mom = kv._updater.states[0].asnumpy()
    kv2 = tmx.kvstore.create("device")
    kv2.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                           momentum=0.9))
    kv2.load_optimizer_states(f)
    np.testing.assert_array_equal(kv2._updater.states[0].asnumpy(), mom)
    assert isinstance(kv2._updater.states[0]._data, torch.Tensor)
