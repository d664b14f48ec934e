"""PyTorch port: user ops in Python (``mx.operator``: ``CustomOp``,
``CustomOpProp``, ``register``, ``nd.Custom``, ``sym.Custom``) against the
JAX package's.

The five cases of ``tests/test_custom_operator.py`` run on both packages
with the same registered op (eager forward, the autograd backward, the
symbolic executor's forward and backward, the registry listing and the
unknown name); ``example/numpy-ops/custom_softmax.py``'s op is exec'd
against each package (its import swapped) and run eagerly, under
autograd, and in a ``Module.fit`` through a symbolic ``Custom`` node.
Values agree with the reference within rtol 1e-5 / atol 1e-6.  A
hybridized block whose forward runs a ``Custom`` op is not captured as a
CUDA graph: the warm-up of a capture sees the op, and the program runs
uncaptured from then on (``gluon.cached_op.UNCAPTURED``), which the last
test drives on the CPU through the capture path with the side-stream
warm-up replaced by a plain call.
"""
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _register_square(mx):
    @mx.operator.register("squareit")
    class SquareProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Square(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.0 * in_data[0] * out_grad[0])

            return Square()

    return SquareProp


_register_square(jmx)
_register_square(tmx)


def _example(pkg):
    """``custom_softmax.py``'s namespace built against ``pkg``."""
    path = os.path.join(ROOT, "example", "numpy-ops", "custom_softmax.py")
    with open(path) as f:
        src = f.read()
    if pkg == "mxnet_tpu_torch":
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    ns = {"__name__": "custom_softmax_example", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


EXAMPLE = {"j": _example("mxnet_tpu"), "t": _example("mxnet_tpu_torch")}


def _eager(mx):
    x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32))
    return mx.nd.Custom(x, op_type="squareit").asnumpy()


def _autograd(mx):
    x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="squareit").sum()
    y.backward()
    return x.grad.asnumpy()


def _symbolic_forward(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        out = mx.sym.Custom(data, op_type="squareit", name="sq")
    exe = out.simple_bind(data=(4,))
    exe.forward(is_train=False,
                data=mx.nd.array(np.array([1, 2, 3, 4], np.float32)))
    return exe.outputs[0].asnumpy()


def _symbolic_backward(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        out = mx.sym.sum(mx.sym.Custom(data, op_type="squareit"))
    exe = out.simple_bind(data=(3,), grad_req="write")
    exe.forward(is_train=True,
                data=mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32)))
    exe.backward()
    return exe.grad_arrays[0].asnumpy()


@pytest.mark.parametrize("case", [_eager, _autograd, _symbolic_forward,
                                  _symbolic_backward],
                         ids=["eager_forward", "autograd_backward",
                              "symbol_executor", "symbol_backward"])
def test_custom_op_matches_jax(case):
    want = {_eager: [1, 4, 9], _autograd: [2, 4, 6],
            _symbolic_forward: [1, 4, 9, 16],
            _symbolic_backward: [2, 4, 6]}[case]
    got, ref = case(tmx), case(jmx)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_custom_registry_listing():
    assert "squareit" in tmx.operator.get_all_registered_operators()
    assert "numpy_softmax" in tmx.operator.get_all_registered_operators()
    with pytest.raises(MXNetError, match="no_such_op"):
        tmx.nd.Custom(tmx.nd.zeros((2,)), op_type="no_such_op")
    with pytest.raises(jmx.MXNetError):
        jmx.nd.Custom(jmx.nd.zeros((2,)), op_type="no_such_op")


def test_assign_requests_and_device():
    """``assign`` under ``write``, ``add`` and ``null``; a numpy source
    lands on the destination's device and dtype stays the source's."""
    op = tmx.operator.CustomOp()
    dst = tmx.nd.array(np.ones(3, np.float32))
    op.assign(dst, "null", np.full(3, 5.0, np.float32))
    np.testing.assert_array_equal(dst.asnumpy(), [1, 1, 1])
    op.assign(dst, "add", tmx.nd.array(np.full(3, 2.0, np.float32)))
    np.testing.assert_array_equal(dst.asnumpy(), [3, 3, 3])
    op.assign(dst, "write", np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(dst.asnumpy(), [0, 1, 2])
    assert dst._data.device == torch.device("cpu")


def test_example_custom_softmax_matches_jax():
    """The example's numpy softmax: forward against ``nd.softmax`` and the
    reference's op, the gradient of its sum against the reference's."""
    rs = np.random.RandomState(0)
    X = rs.randn(8, 10).astype(np.float32)
    G = rs.randn(8, 10).astype(np.float32)
    res = {}
    for tag, mx in (("j", jmx), ("t", tmx)):
        x = mx.nd.array(X)
        out = mx.nd.Custom(x, op_type="numpy_softmax")
        ref = mx.nd.softmax(x, axis=1)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="numpy_softmax")
        y.backward(mx.nd.array(G))
        res[tag] = (out.asnumpy(), ref.asnumpy(), x.grad.asnumpy())
    np.testing.assert_allclose(res["t"][0], res["t"][1], **TOL)
    for a, b in zip(res["t"], res["j"]):
        np.testing.assert_allclose(a, b, **TOL)
    # the example's main() runs as it is under the port
    EXAMPLE["t"]["main"](type("A", (), {"batch_size": 4})())


def _softmax_fit(mx, X, Y, W0):
    """Two epochs of ``Module.fit`` (SGD) over FullyConnected -> the
    example's numpy softmax as a ``Custom`` node -> a log-loss head:
    the learned weight."""
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        fc = mx.sym.FullyConnected(data, num_hidden=10, no_bias=True,
                                   name="fc")
        p = mx.sym.Custom(fc, op_type="numpy_softmax", name="sm")
        ce = -mx.sym.sum(mx.sym.log(mx.sym.pick(p, label, axis=1) + 1e-6))
        net = mx.sym.MakeLoss(ce)
    it = mx.io.NDArrayIter(X, Y, batch_size=4)
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["softmax_label"],
                        context=mx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd", eval_metric="loss",
            optimizer_params={"learning_rate": 0.1},
            arg_params={"fc_weight": mx.nd.array(W0)},
            initializer=mx.init.Zero())
    return mod.get_params()[0]["fc_weight"].asnumpy()


def test_module_fit_through_symbolic_custom():
    rs = np.random.RandomState(1)
    X = rs.randn(16, 6).astype(np.float32)
    Y = rs.randint(0, 10, 16).astype(np.float32)
    W0 = (rs.randn(10, 6) * 0.1).astype(np.float32)
    got = _softmax_fit(tmx, X, Y, W0)
    ref = _softmax_fit(jmx, X, Y, W0)
    assert not np.allclose(got, W0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_hybridized_custom_runs_uncaptured(monkeypatch):
    """The capture path of a hybridized block (driven on the CPU, the
    side-stream warm-up a plain call): the warm-up sees the ``Custom``
    op, no CUDA graph is made, and every call runs the program uncaptured,
    with the eager block's values."""
    from mxnet_tpu_torch.gluon import cached_op, nn

    class Net(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="squareit")

    monkeypatch.setattr(cached_op, "warm_up", lambda fn, device=None: fn())
    monkeypatch.setitem(cached_op.UNCAPTURED, "programs", 0)
    monkeypatch.setitem(cached_op.UNCAPTURED, "calls", 0)
    net = Net()
    net.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(np.random.RandomState(2).randn(2, 3)
                     .astype(np.float32))
    want = net(x).asnumpy()
    net.hybridize()
    net(x)                                     # builds the program
    (prog,) = net._cached_ops.values()
    for _ in range(2):
        flat = [x._data]
        out = prog(flat, tmx.random.next_key(), False, capture=True)
        np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert prog._host_only == "Custom"
    assert prog._captures == {(False, (False,)): []}
    assert cached_op.UNCAPTURED == {"programs": 1, "calls": 2}
