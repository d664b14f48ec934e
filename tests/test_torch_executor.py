"""PyTorch port: the symbolic loss heads and the ``Executor`` against the
JAX package's.

- The loss heads (``SoftmaxOutput`` across probability labels,
  ``multi_output``, ``use_ignore``/``ignore_label``, the three
  ``normalization`` modes, ``smooth_alpha``, ``grad_scale`` and
  ``out_grad``; the three regression heads; ``MakeLoss``;
  ``SoftmaxActivation``): forward and gradient, the incoming cotangent a
  random one, against the reference's custom vjp; f32 rtol 1e-5.
- The executor on the example symbols (mlp, lenet, the cifar ResNet-20) at
  B=4, bound with identical numpy arguments and aux states: training
  forward outputs, every gradient under ``grad_req`` write and add, the
  moving-statistic updates, then an inference forward on them; rtol 1e-4
  (the model-level tolerance: XLA:CPU and torch order their sums
  differently).  Also ``backward(out_grads)``, ``Symbol.grad``/``eval``,
  ``reshape``, ``copy_params_from`` and the refusals.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

from test_torch_symbol import example_symbol

HEAD_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# loss heads
# ---------------------------------------------------------------------------

def _labels(rs, shape, nclass, ignore=None):
    lab = rs.randint(0, nclass, size=shape).astype(np.float32)
    if ignore is not None:
        lab.flat[::3] = ignore
    return lab


def _softmax_cases():
    rs = np.random.RandomState(0)
    x2 = rs.randn(6, 5).astype(np.float32)
    x4 = rs.randn(3, 4, 2, 3).astype(np.float32)
    prob = np.abs(rs.randn(6, 5)).astype(np.float32)
    prob /= prob.sum(1, keepdims=True)
    return {
        "plain": (x2, _labels(rs, (6,), 5), {}),
        "batch": (x2, _labels(rs, (6,), 5), {"normalization": "batch",
                                             "grad_scale": 2.0}),
        "valid_ignore": (x2, _labels(rs, (6,), 5, ignore=-1.0),
                         {"normalization": "valid", "use_ignore": True}),
        "valid_no_ignore": (x2, _labels(rs, (6,), 5),
                            {"normalization": "valid"}),
        "ignore_label_3": (x2, _labels(rs, (6,), 5, ignore=3.0),
                           {"use_ignore": True, "ignore_label": 3.0}),
        "smooth": (x2, _labels(rs, (6,), 5), {"smooth_alpha": 0.1}),
        "out_grad": (x2, _labels(rs, (6,), 5), {"out_grad": True,
                                                "grad_scale": 0.5}),
        "prob_labels": (x2, prob, {"grad_scale": 1.5}),
        "prob_labels_out_grad": (x2, prob, {"out_grad": True}),
        "multi_output": (x4, _labels(rs, (3, 2, 3), 4),
                         {"multi_output": True}),
        "multi_output_batch": (x4, _labels(rs, (3, 2, 3), 4),
                               {"multi_output": True,
                                "normalization": "batch"}),
        "multi_output_valid_ignore": (
            x4, _labels(rs, (3, 2, 3), 4, ignore=-1.0),
            {"multi_output": True, "normalization": "valid",
             "use_ignore": True}),
    }


def _head_pair(opname, data, label, attrs, seed=1):
    """(jax out, jax grad, torch out, torch grad) for a random cotangent."""
    g = np.random.RandomState(seed).randn(*data.shape).astype(np.float32)
    jop = jmx.ops.registry.get_op(opname).fn
    jout, vjp = jax.vjp(lambda d: jop(d, jnp.asarray(label), **attrs),
                        jnp.asarray(data))
    (jg,) = vjp(jnp.asarray(g))
    td = torch.tensor(data, requires_grad=True)
    tout = tmx.ops.registry.get_op(opname).fn(td, torch.tensor(label),
                                              **attrs)
    (tg,) = torch.autograd.grad(tout, td, torch.tensor(g))
    return np.asarray(jout), np.asarray(jg), tout.detach().numpy(), \
        tg.numpy()


@pytest.mark.parametrize("case", sorted(_softmax_cases()))
def test_softmax_output_forward_and_gradient(case):
    data, label, attrs = _softmax_cases()[case]
    jo, jg, to, tg = _head_pair("SoftmaxOutput", data, label, attrs)
    np.testing.assert_allclose(to, jo, **HEAD_TOL)
    np.testing.assert_allclose(tg, jg, **HEAD_TOL)
    if not attrs.get("out_grad"):
        # the head's gradient does not depend on the incoming cotangent
        _, _, _, tg2 = _head_pair("SoftmaxOutput", data, label, attrs,
                                  seed=7)
        np.testing.assert_array_equal(tg, tg2)


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "MAERegressionOutput",
                                "LogisticRegressionOutput"])
@pytest.mark.parametrize("attrs", [{}, {"grad_scale": 3.0},
                                   {"out_grad": True}],
                         ids=["plain", "grad_scale", "out_grad"])
def test_regression_heads(op, attrs):
    rs = np.random.RandomState(2)
    data = rs.randn(5, 3).astype(np.float32)
    label = rs.randn(5, 3).astype(np.float32)
    jo, jg, to, tg = _head_pair(op, data, label, attrs)
    np.testing.assert_allclose(to, jo, **HEAD_TOL)
    np.testing.assert_allclose(tg, jg, **HEAD_TOL)


def test_make_loss_and_softmax_activation():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 2, 2).astype(np.float32)
    for mode in ("instance", "channel"):
        j = jmx.ops.registry.get_op("SoftmaxActivation").fn(jnp.asarray(x),
                                                            mode=mode)
        t = tmx.ops.registry.get_op("SoftmaxActivation").fn(torch.tensor(x),
                                                            mode=mode)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **HEAD_TOL)
    td = torch.tensor(x, requires_grad=True)
    out = tmx.ops.registry.get_op("MakeLoss").fn(td * 2.0)
    (g,) = torch.autograd.grad(out.sum(), td)
    np.testing.assert_array_equal(g.numpy(), np.full_like(x, 2.0))


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _shapes(name):
    return {"mlp": (4, 1, 28, 28), "lenet": (4, 1, 28, 28),
            "resnet20": (4, 3, 32, 32)}[name]


def _sym(pkg, name):
    if name == "resnet20":
        return example_symbol(pkg, "resnet.py", num_classes=10,
                              num_layers=20, image_shape="3,32,32")
    return example_symbol(pkg, name + ".py", num_classes=10)


def _values(sym, data_shape, seed=0):
    """Numpy arguments and aux states for ``sym`` (weights scaled by fan-in,
    moving variances positive, labels in range)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rs.randint(0, 10, size=s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = (1 + 0.1 * rs.randn(*s)).astype(np.float32)
        else:
            fan = int(np.prod(s[1:])) if len(s) > 1 else 1
            args[n] = (rs.randn(*s) / np.sqrt(max(fan, 1))).astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (0.1 * rs.randn(*s) if n.endswith("mean")
                  else 1 + 0.5 * rs.rand(*s)).astype(np.float32)
    return args, aux


def _bind(pkg, sym, args, aux, grad_req):
    ex = sym.simple_bind(ctx=pkg.cpu(), grad_req=grad_req,
                         data=args["data"].shape)
    for n, v in args.items():
        if pkg is jmx:
            ex.arg_dict[n]._data = jnp.asarray(v)
        else:
            ex.arg_dict[n]._data.copy_(torch.from_numpy(v))
    for n, v in aux.items():
        if pkg is jmx:
            ex.aux_dict[n]._data = jnp.asarray(v)
        else:
            ex.aux_dict[n]._data.copy_(torch.from_numpy(v))
    return ex


def _np(a):
    return a.asnumpy()


@pytest.mark.parametrize("name", ["mlp", "lenet", "resnet20"])
@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_forward_backward(name, grad_req):
    js, ts = _sym(jmx, name), _sym(tmx, name)
    args, aux = _values(js, _shapes(name))
    je = _bind(jmx, js, args, aux, grad_req)
    te = _bind(tmx, ts, args, aux, grad_req)
    assert te._arg_names == je._arg_names
    assert te._aux_names == je._aux_names
    rounds = 2 if grad_req == "add" else 1
    for _ in range(rounds):
        jo = je.forward(is_train=True)
        to = te.forward(is_train=True)
        je.backward()
        te.backward()
        for a, b in zip(to, jo):
            np.testing.assert_allclose(_np(a), _np(b), **MODEL_TOL)
    for n in je._grad_arg_names:
        if n == "softmax_label":
            # the reference's head returns a zero label cotangent
            assert not np.any(_np(te.grad_dict[n]))
            continue
        g_ref = _np(je.grad_dict[n])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(_np(te.grad_dict[n]), g_ref,
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)
    for n in je._aux_names:
        np.testing.assert_allclose(_np(te.aux_dict[n]), _np(je.aux_dict[n]),
                                   **MODEL_TOL, err_msg=n)
    # inference reads the updated moving statistics
    jo = je.forward(is_train=False)
    to = te.forward(is_train=False)
    np.testing.assert_allclose(_np(to[0]), _np(jo[0]), **MODEL_TOL)


def test_backward_with_out_grads_and_listing():
    js, ts = _sym(jmx, "mlp"), _sym(tmx, "mlp")
    args, aux = _values(js, _shapes("mlp"))
    je = _bind(jmx, js, args, aux, "write")
    te = _bind(tmx, ts, args, aux, "write")
    je.forward(is_train=True)
    te.forward(is_train=True)
    og = np.random.RandomState(5).randn(4, 10).astype(np.float32)
    je.backward(out_grads=[jmx.nd.array(og)])
    te.backward(out_grads=[tmx.nd.array(og)])
    for n in je._grad_arg_names:
        np.testing.assert_allclose(_np(te.grad_dict[n]),
                                   _np(je.grad_dict[n]), **MODEL_TOL)
    assert list(te.output_dict) == list(je.output_dict)
    assert [a.shape for a in te.arg_arrays] == [a.shape for a in je.arg_arrays]
    assert [g is None for g in te.grad_arrays] == \
        [g is None for g in je.grad_arrays]
    with pytest.raises(MXNetError, match="before forward"):
        _bind(tmx, ts, args, aux, "write").backward()


def test_symbol_grad_and_eval():
    def build(pkg):
        with pkg.name.NameManager():
            x, w = pkg.sym.Variable("x"), pkg.sym.Variable("w")
            return pkg.sym.sum(pkg.sym.tanh(x * w) + x, axis=1)

    rs = np.random.RandomState(4)
    x, w = rs.randn(3, 4).astype(np.float32), rs.randn(3, 4).astype(np.float32)
    jg = build(jmx).grad(["x", "w"]).eval(ctx=jmx.cpu(), x=jmx.nd.array(x),
                                          w=jmx.nd.array(w))
    tg = build(tmx).grad(["x", "w"]).eval(ctx=tmx.cpu(), x=tmx.nd.array(x),
                                          w=tmx.nd.array(w))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **HEAD_TOL)
    je = build(jmx).eval(ctx=jmx.cpu(), x=jmx.nd.array(x), w=jmx.nd.array(w))
    te = build(tmx).eval(ctx=tmx.cpu(), x=tmx.nd.array(x), w=tmx.nd.array(w))
    np.testing.assert_allclose(_np(te[0]), _np(je[0]), **HEAD_TOL)


def test_reshape_and_copy_params():
    ts = _sym(tmx, "mlp")
    args, aux = _values(ts, _shapes("mlp"))
    te = _bind(tmx, ts, args, aux, "write")
    te2 = te.reshape(data=(2, 1, 28, 28), softmax_label=(2,))
    assert te2.arg_dict["data"].shape == (2, 1, 28, 28)
    np.testing.assert_array_equal(_np(te2.arg_dict["fc1_weight"]),
                                  args["fc1_weight"])
    with pytest.raises(MXNetError, match="unknown argument"):
        te.copy_params_from({"nope": tmx.nd.zeros((1,))})
    with pytest.raises(MXNetError, match="shape"):
        te.copy_params_from({"fc1_weight": tmx.nd.zeros((1,))})
    seen = []
    te.set_monitor_callback(lambda n, a: seen.append(n))
    te.forward(is_train=False)
    assert seen == ts.list_outputs()


def test_executor_refusals():
    """``group2ctx`` binds (a symbol without groups runs on the default
    group, one segment); ``set_spmd`` validates as the reference's and
    detaches with ``None``; the fused step refuses ``group2ctx`` with a
    loss scaler as without (loss scaling itself is ported:
    ``tests/test_torch_amp.py``); ``telemetry_snapshot`` is empty before a
    fused step and holds the reference's keys as f32 device scalars after
    one."""
    ts = _sym(tmx, "mlp")
    tg = ts.simple_bind(ctx=tmx.cpu(), data=(4, 1, 28, 28),
                        group2ctx={"a": tmx.cpu()})
    assert tg._grouped.num_segments == 1
    te = ts.simple_bind(ctx=tmx.cpu(), data=(4, 1, 28, 28))
    mesh = types.SimpleNamespace(axis_names=("dp",), shape={"dp": 3},
                                 size=3)
    with pytest.raises(MXNetError, match="not divisible by the dp mesh"):
        te.set_spmd(mesh, ["data"])
    with pytest.raises(MXNetError, match="unknown batch argument"):
        te.set_spmd(mesh, ["nope"])
    te.set_spmd(None, ["data"])
    assert te._spmd_mesh is None
    opt = tmx.optimizer.create("sgd")
    with pytest.raises(MXNetError, match="group2ctx"):
        tg.fused_step(opt, {}, [], loss_scaler=tmx.amp.LossScaler())
    assert te.telemetry_snapshot() == {}
    tf = _sym(tmx, "mlp").simple_bind(ctx=tmx.cpu(), data=(4, 1, 28, 28))
    gnames = tf._grad_arg_names
    for n in gnames:
        tf.arg_dict[n]._data.normal_(0, 0.1)
    upd = tmx.optimizer.get_updater(opt)
    states = {n: upd._state(i, tf.arg_dict[n]) for i, n in enumerate(gnames)}
    tf.fused_step(opt, states, [(n, i) for i, n in enumerate(gnames)],
                  feed={"data": np.ones((4, 1, 28, 28), np.float32)})
    snap = tf.telemetry_snapshot()
    assert sorted(snap) == sorted(["grad_norm", "param_norm", "loss",
                                   "nonfinite_grad_count", "skip_step"])
    for v in snap.values():
        assert isinstance(v, torch.Tensor) and v.dim() == 0
        assert v.dtype == torch.float32 and bool(torch.isfinite(v))
    assert float(snap["param_norm"]) > 0 and float(snap["skip_step"]) == 0


def test_outputs_that_are_also_consumed():
    # a node both read by a later node and bound as an output keeps its
    # value (the executor drops values after their last consumer)
    def build(pkg):
        with pkg.name.NameManager():
            x = pkg.sym.Variable("x")
            h = pkg.sym.FullyConnected(x, num_hidden=3, name="fc")
            r = pkg.sym.relu(h)
            return pkg.sym.Group([h, r * 2.0, r])

    rs = np.random.RandomState(8)
    vals = {"x": rs.randn(2, 4).astype(np.float32),
            "fc_weight": rs.randn(3, 4).astype(np.float32),
            "fc_bias": rs.randn(3).astype(np.float32)}
    outs = []
    for pkg in (jmx, tmx):
        ex = build(pkg).bind(ctx=pkg.cpu(), grad_req="null", args={
            k: pkg.nd.array(v) for k, v in vals.items()})
        outs.append([_np(o) for o in ex.forward(is_train=True)])
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, **HEAD_TOL)
