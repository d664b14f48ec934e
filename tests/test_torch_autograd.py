"""PyTorch port: the autograd tape API against the JAX package's.

The same numpy inputs (from a seed) go through both packages'
``record``/``pause`` scopes, ``attach_grad``, ``mark_variables``,
``backward`` (with and without head gradients), ``grad`` (first and
second order) and a custom ``Function``; gradients agree to rtol 1e-6
(atol 1e-7).  ``grad_req="write"`` over two backwards leaves one gradient
and ``"add"`` the sum, for ``attach_grad`` arrays and for Gluon
``Parameter``s, in both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-6, atol=1e-7)
PKGS = (jmx, tmx)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(fn):
    """``fn(package)`` for the JAX package and the port."""
    return [fn(mx) for mx in PKGS]


def _close(want, got):
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_scope_flags():
    for mx in PKGS:
        ag = mx.autograd
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.predict_mode():
                assert ag.is_recording() and not ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        assert not ag.is_recording() and not ag.is_training()


def _attach_backward(mx, x, head_grad=None):
    a = mx.nd.array(x)
    a.attach_grad()
    with mx.autograd.record():
        y = (a * a + 2 * a).exp() / 10 + a.sum(axis=1, keepdims=True)
    if head_grad is None:
        y.backward()
    else:
        y.backward(mx.nd.array(head_grad))
    return a.grad, y


def test_attach_grad_backward():
    x = _x(1) * 0.3
    (jg, jy), (tg, ty) = _both(lambda mx: _attach_backward(mx, x))
    _close(jy, ty)
    _close(jg, tg)


def test_backward_with_head_grads():
    x, hg = _x(2) * 0.3, _x(3)
    (jg, _), (tg, _) = _both(lambda mx: _attach_backward(mx, x, hg))
    _close(jg, tg)


def test_mark_variables_and_multiple_heads():
    x1, x2, h = _x(4), _x(5), _x(6)

    def run(mx):
        a, b = mx.nd.array(x1), mx.nd.array(x2)
        ga, gb = mx.nd.zeros(a.shape), mx.nd.zeros(b.shape)
        mx.autograd.mark_variables([a, b], [ga, gb], grad_reqs="write")
        with mx.autograd.record():
            y1 = a * b
            y2 = (a - b).square().sum()
        mx.autograd.backward([y1, y2], head_grads=[mx.nd.array(h), None])
        return ga, gb

    (ja, jb), (ta, tb) = _both(run)
    _close(ja, ta)
    _close(jb, tb)


def test_grad_first_and_second_order():
    x = _x(7) * 0.5

    def run(mx):
        a = mx.nd.array(x)
        a.attach_grad()
        with mx.autograd.record():
            y = a * a * a
            (d1,) = mx.autograd.grad([y], [a], create_graph=True)
            z = (d1 * a).sum()
        z.backward()
        with mx.autograd.record():
            w = (a * a).sum()
        (plain,) = mx.autograd.grad(w, [a])
        return d1, a.grad, plain

    (j1, j2, jp), (t1, t2, tp) = _both(run)
    _close(j1, t1)      # 3 x^2
    _close(j2, t2)      # d/dx sum(3 x^3) = 9 x^2
    _close(jp, tp)      # 2 x
    assert not t1._data.is_leaf


def test_pause_and_unconnected_variables():
    x = _x(8)

    def run(mx):
        a, b = mx.nd.array(x), mx.nd.array(x + 1)
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = a * a
            with mx.autograd.pause():
                c = a * 3   # a constant to the graph
            z = (y + c).sum()
        z.backward()
        return a.grad, b.grad

    (ja, jb), (ta, tb) = _both(run)
    _close(ja, ta)
    _close(jb, tb)
    assert not tb.asnumpy().any()


def test_no_graph_outside_record():
    a = tmx.nd.array(_x(9))
    a.attach_grad()
    y = a * 2 + 1
    assert not y._data.requires_grad
    with tmx.autograd.record():
        z = a * 2
    assert z._data.requires_grad


def test_inplace_write_to_marked_variable_refused():
    for mx in PKGS:
        a = mx.nd.array(_x(10))
        a.attach_grad()
        with mx.autograd.record():
            with pytest.raises(Exception, match="in-place"):
                a += 1


def _sigmoid_fn(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + (-x).exp())
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    return Sigmoid()


def test_custom_function():
    x, h = _x(11), _x(12)

    def run(mx):
        a = mx.nd.array(x)
        a.attach_grad()
        with mx.autograd.record():
            y = _sigmoid_fn(mx)(a * 2)
        y.backward(mx.nd.array(h))
        out = _sigmoid_fn(mx)(a)   # outside record: forward only
        return y, a.grad, out

    (jy, jg, jo), (ty, tg, to) = _both(run)
    _close(jy, ty)
    _close(jg, tg)
    _close(jo, to)


def _two_backwards(mx, x, req):
    a = mx.nd.array(x)
    a.attach_grad(grad_req=req)
    for _ in range(2):
        with mx.autograd.record():
            y = (a * a * 3).sum()
        y.backward()
    return a.grad


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_add_accumulates(req):
    x = _x(13)
    jg, tg = _both(lambda mx: _two_backwards(mx, x, req))
    _close(jg, tg)
    one = 6 * x
    np.testing.assert_allclose(tg.asnumpy(), one if req == "write"
                               else 2 * one, **TOL)


def _dense(mx, w, b):
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    net.weight.set_data(mx.nd.array(w))
    net.bias.set_data(mx.nd.array(b))
    return net


@pytest.mark.parametrize("req", ["write", "add"])
def test_parameter_grad_req(req):
    """Two backwards through a Gluon block without zero_grad: one gradient
    with ``grad_req="write"`` (the default), their sum with ``"add"``."""
    w, b, x = _x(14, (3, 4)), _x(15, (3,)), _x(16, (5, 4))

    def run(mx):
        net = _dense(mx, w, b)
        for p in net.collect_params().values():
            p.grad_req = req
        grads = []
        for _ in range(2):
            with mx.autograd.record():
                y = (net(mx.nd.array(x)) ** 2).sum()
            y.backward()
            grads.append(net.weight.grad().asnumpy().copy())
        return grads, net.bias.grad()

    (jgs, jb), (tgs, tb) = _both(run)
    for jg, tg in zip(jgs, tgs):
        np.testing.assert_allclose(tg, jg, **TOL)
    _close(jb, tb)
    want = tgs[0] if req == "write" else 2 * tgs[0]
    np.testing.assert_allclose(tgs[1], want, **TOL)
    # zero_grad clears the buffer
    net = _dense(tmx, w, b)
    with tmx.autograd.record():
        (net(tmx.nd.array(x)) ** 2).sum().backward()
    assert net.weight.grad().asnumpy().any()
    net.collect_params().zero_grad()
    assert not net.weight.grad().asnumpy().any()


def test_block_returns_tensors_for_tensors():
    net = _dense(tmx, _x(17, (3, 4)), _x(18, (3,)))
    out = net(torch.from_numpy(_x(19, (2, 4))))
    assert isinstance(out, torch.Tensor)
    nd_out = net(tmx.nd.array(_x(19, (2, 4))))
    assert isinstance(nd_out, tmx.nd.NDArray)
    assert not nd_out._data.requires_grad   # not recording
    np.testing.assert_array_equal(nd_out.asnumpy(), out.detach().numpy())


def test_backward_without_variables_raises():
    # a thread with no live marked variable: run in a fresh thread
    import threading

    err = []

    def body():
        with tmx.cpu():
            a = tmx.nd.array(_x(20))
            with tmx.autograd.record():
                y = (a * 2).sum()
            try:
                y.backward()
            except MXNetError as e:
                err.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert err and "attach_grad" in str(err[0])
