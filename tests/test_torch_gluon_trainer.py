"""PyTorch port: the imperative Gluon training loop against the JAX
package's.

Both packages run the same loop, as a user writes it::

    with autograd.record():
        L = loss_fn(net(x), y)
    L.backward()
    trainer.step(x.shape[0])

on ``tests/test_torch_resnet.py``'s small channels-last net
(``ResNetV1(BottleneckV1, [1, 1], [16, 128, 256], classes=10,
thumbnail=True, layout="NHWC")``, B = 4, 16x16), its parameters and
running statistics numpy from a seed (the port's through
``params_from_jax``), with ``SoftmaxCrossEntropyLoss`` and
``gluon.Trainer(..., "sgd", {"learning_rate": 0.1, "momentum": 0.9,
"wd": 1e-4})`` over the ``device`` kvstore, for two steps on two batches.
``MXTPU_BN_PALLAS=1`` (monkeypatch) sends the reference's BatchNorms at
C % 128 == 0 through its Pallas kernels (the interpreter).

Tolerances: step-1 per-sample losses rtol 1e-5, step-2 rtol 1e-4; every
gradient 1e-4 normwise (a conv bias feeding a training BatchNorm has an
analytically zero gradient: both sides are held below 1e-6 of the largest
gradient's norm there); the weights after each step and the running
statistics rtol 1e-5 / atol 1e-6.  With ``compression_params={"type":
"2bit", "threshold": 0.5}`` the same, and the dequantized gradients each
step pulls back are equal element for element, except where the
reference's ``g + residual`` lies within 1e-5 of +-t (either code is
right there: the packages' gradients differ by rounding); those elements
are counted (at most 1%) and left out of the weight comparison.  Files:
``save_parameters`` of the same weights writes the same bytes in both
packages, and each package's file loads into a fresh net of the other
with predict-mode outputs equal to the saving net's, bit for bit.  A
Dense net whose shapes resolve only at the first forward, after the
``Trainer`` was made, trains as the reference's does.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

B, HW, CLASSES = 4, 16, 10
NEAR = 1e-5
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
COMP = {"type": "2bit", "threshold": 0.5}


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


def _build(mx):
    v = mx.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1, 1], [16, 128, 256],
                      classes=CLASSES, thumbnail=True, layout="NHWC")


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("running_var"):
            v = 1.0 + 0.2 * rs.rand(*shape)
        elif name.endswith("gamma"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * rs.randn(*shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        out[name] = v.astype(np.float32)
    return out


def _nets():
    """(JAX net, port net) holding the same parameters."""
    state = np.random.get_state()   # the reference initializer draws here
    try:
        np.random.seed(0)
        jnet = _build(jmx)
        jnet.initialize()
        jnet(jmx.nd.array(np.zeros((1, HW, HW, 3), np.float32)))
    finally:
        np.random.set_state(state)
    jpd = jnet.collect_params()
    arrays = _arrays({k: p.shape for k, p in jpd.items()}, 11)
    for k, p in jpd.items():
        p.set_data(jmx.nd.array(arrays[k]))
    tnet = _build(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    with tmx.autograd.pause():
        tnet(tmx.nd.zeros((1, HW, HW, 3)))
    tmx.gluon.params_from_jax(tnet, arrays)
    return jnet, tnet


def _batches():
    rs = np.random.RandomState(5)
    return [((rs.randn(B, HW, HW, 3) * 1.5 + 0.3).astype(np.float32),
             rs.randint(0, CLASSES, B).astype(np.int32)) for _ in range(2)]


def _by_suffix(net, fn):
    """``{name without the root prefix: fn(parameter)}``."""
    return {k[len(net.prefix):]: fn(p)
            for k, p in net.collect_params().items()}


def _loop(mx, net, compression):
    """Two steps of the user loop; per step the losses, the gradients
    after backward, the gradients after step (pulled back from the
    store), the parameters and the store's residuals."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                               compression_params=compression)
    trainable = lambda p: p.grad_req != "null"   # noqa: E731
    steps = []
    for x, y in _batches():
        x, y = mx.nd.array(x), mx.nd.array(y)
        with mx.autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        grads = _by_suffix(net, lambda p: p.grad().asnumpy()
                           if trainable(p) else None)
        trainer.step(x.shape[0])
        pulled = _by_suffix(net, lambda p: p.grad().asnumpy()
                            if trainable(p) else None)
        params = _by_suffix(net, lambda p: p.data().asnumpy())
        kv = trainer._kvstore
        res = {}
        if compression:
            idx = {i: k for k, i in trainer._param2idx.items()}
            res = {idx[i][len(net.prefix):]: np.asarray(
                v if isinstance(v, np.ndarray) else
                (v.numpy() if isinstance(v, torch.Tensor) else v))
                for (i, _), v in kv._residuals.items()}
        steps.append(dict(loss=L.asnumpy(), grads=grads, pulled=pulled,
                          params=params, residuals=res))
    return steps


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_grads(want, got):
    want = {k: v for k, v in want.items() if v is not None}
    got = {k: v for k, v in got.items() if v is not None}
    assert set(want) == set(got)
    top = max(np.linalg.norm(v) for v in want.values())
    zero = {k for k, v in want.items() if np.linalg.norm(v) < 1e-6 * top}
    assert all("conv2d" in k and k.endswith("bias") for k in zero)
    for k in want:
        if k in zero:
            assert np.linalg.norm(got[k]) < 1e-6 * top, k
        else:
            assert _normwise(got[k], want[k]) <= 1e-4, ("grad", k)
    return zero


@pytest.mark.parametrize("compression", [None, COMP], ids=["plain", "2bit"])
def test_trainer_loop_matches_jax(monkeypatch, compression):
    monkeypatch.setenv("MXTPU_BN_PALLAS", "1")
    jnet, tnet = _nets()
    want = _loop(jmx, jnet, compression)
    got = _loop(tmx, tnet, compression)
    t = COMP["threshold"]
    near_total, elements = 0, 0
    skip = {}
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"], w["loss"],
                                   rtol=1e-5 if step == 0 else 1e-4)
        zero = _check_grads(w["grads"], g["grads"])
        if compression:
            # the codes pulled back: exact away from the threshold
            for k, wg in w["grads"].items():
                if wg is None:
                    continue
                prev = want[step - 1]["residuals"][k] if step else 0.0
                s = wg + prev
                near = (np.abs(np.abs(s) - t) < NEAR) | skip.get(k, False)
                skip[k] = near
                near_total += int(near.sum())
                elements += s.size
                np.testing.assert_array_equal(
                    g["pulled"][k][~near], w["pulled"][k][~near], err_msg=k)
                if k not in zero:
                    err = _normwise(np.where(near, 0, g["residuals"][k]),
                                    np.where(near, 0, w["residuals"][k]))
                    assert err <= 1e-4, ("residual", k, err)
        for k, wp in w["params"].items():
            mask = ~skip.get(k, np.zeros(wp.shape, bool))
            np.testing.assert_allclose(g["params"][k][mask], wp[mask],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert any("running_mean" in k for k in want[-1]["params"])
    if compression:
        print(f"elements within {NEAR} of +-t: {near_total} of {elements}")
        assert near_total <= 0.01 * elements


def test_parameter_files_cross_packages(tmp_path):
    jnet, tnet = _nets()
    jf, tf = tmp_path / "j.params", tmp_path / "t.params"
    jnet.save_parameters(str(jf))
    tnet.save_parameters(str(tf))
    assert tf.read_bytes() == jf.read_bytes()
    x = _batches()[0][0]
    tout = tnet(tmx.nd.array(x)).asnumpy()
    jout = jnet(jmx.nd.array(x)).asnumpy()
    # each package's file into a fresh net of the other
    tnet2 = _build(tmx)
    tnet2.load_parameters(str(jf), ctx=tmx.cpu())
    np.testing.assert_array_equal(tnet2(tmx.nd.array(x)).asnumpy(), tout)
    jnet2 = _build(jmx)
    jnet2.load_parameters(str(tf))
    np.testing.assert_array_equal(jnet2(jmx.nd.array(x)).asnumpy(), jout)
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


def test_deferred_shapes_and_trainer_api(tmp_path):
    """The Trainer is made before the first forward resolves the shapes;
    it kvstore-inits them at its next step.  Weights from one numpy seed;
    three steps of the loop in both packages (rtol 1e-5 / atol 1e-6)."""
    rs = np.random.RandomState(3)
    x = rs.randn(6, 5).astype(np.float32)
    y = rs.randint(0, 3, 6).astype(np.int32)
    outs = []
    for mx in (jmx, tmx):
        net = _mlp(mx)
        net.initialize(ctx=mx.cpu())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.2, "momentum": 0.5})
        assert trainer.learning_rate == 0.2
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for step in range(3):
            with mx.autograd.record():
                L = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
            if step == 0:
                # shapes resolved: load the same weights on both sides
                init = np.random.RandomState(4)
                for k, p in sorted(net.collect_params().items()):
                    p.set_data(mx.nd.array(
                        (init.randn(*p.shape) * 0.5).astype(np.float32)))
                with mx.autograd.record():
                    L = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
            L.backward()
            trainer.step(6)
        trainer.set_learning_rate(0.05)
        assert trainer.learning_rate == 0.05
        outs.append([p.data().asnumpy() for _, p in
                     sorted(net.collect_params().items())])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_allreduce_update_equals_step_and_states_round_trip(tmp_path):
    rs = np.random.RandomState(6)
    x = rs.randn(6, 5).astype(np.float32)
    y = rs.randint(0, 3, 6).astype(np.int32)
    runs = []
    for split in (False, True):
        net = _mlp(tmx)
        net.initialize(ctx=tmx.cpu())
        with tmx.autograd.pause():
            net(tmx.nd.array(x))
        init = np.random.RandomState(7)
        for k, p in sorted(net.collect_params().items()):
            p.set_data(tmx.nd.array(init.randn(*p.shape).astype(np.float32)))
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            with tmx.autograd.record():
                L = loss_fn(net(tmx.nd.array(x)), tmx.nd.array(y))
            L.backward()
            if split:
                trainer.allreduce_grads()
                trainer.update(6)
            else:
                trainer.step(6)
        f = str(tmp_path / f"t{split}.states")
        trainer.save_states(f)
        trainer.load_states(f)
        assert trainer._optimizer.param_dict[0] is trainer._params[0]
        runs.append([p.data().asnumpy() for _, p in
                     sorted(net.collect_params().items())])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
