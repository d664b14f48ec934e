"""PyTorch port: the mesh-less ``DataParallelTrainer`` against the JAX
package's, plain and with 2-bit gradient compression.

Both packages get the same network: the MLP of
``tests/test_gradient_compression.py`` (``Dense(32, relu, in_units=16)``,
``Dense(4, in_units=32)``, here under one name scope) and a small
channels-last ResNet v1; the port's parameters are carried from the
reference's with ``params_from_jax``, the batches are numpy from a seed.
The reference trainer runs with ``mesh=None`` (any ambient mesh another
test installed is hidden) and ``donate=False``; on the JAX side the
compressed step runs the Pallas pack and unpack kernels through the
interpreter, on the port's side their plain versions.

Tolerances.  f32: losses, parameters, momenta and residuals rtol 1e-5 /
atol 1e-6 (the MLP), ResNet gradients and residuals 1e-4 normwise as in
``tests/test_torch_resnet.py``.  The quantizer is discontinuous at +-t:
the two packages' f32 gradients differ by rounding, so an element whose
``g + residual`` lies within 1e-5 of +-t may take the other code.  The
compressed comparisons therefore hold every element away from the
threshold exactly to the reference's code, count the elements near it,
and require that count to be at most 1% of the elements (the test
prints it: 1 of the MLP's 676 elements over three steps and 44 of the
ResNet's 115,482, where 19,662 codes are nonzero, for these seeds).  bf16 compute: the loss within 2e-2
relative and each step's parameter change within 5e-2 normwise (both
packages compute in bf16 but round at different places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.parallel.mesh as jmesh
from mxnet_tpu import gluon as jgluon, nd
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import twobit as tb
from mxnet_tpu_torch.parallel import DataParallelTrainer as TTrainer

TOL = dict(rtol=1e-5, atol=1e-6)
NEAR = 1e-5            # |g + residual| this close to t may take either code
LR, MOMENTUM = 0.05, 0.9


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_ambient_mesh(monkeypatch):
    """The reference trainer adopts an installed mesh when given none."""
    monkeypatch.setattr(jmesh, "_current_mesh", None)


def _mlp(pkg):
    net = pkg.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.nn.Dense(32, activation="relu", in_units=16),
                pkg.nn.Dense(4, in_units=32))
    return net


def _mlps(seed=0):
    """(JAX MLP, port MLP) with the same parameters."""
    state = np.random.get_state()   # the reference initializer draws here
    try:
        np.random.seed(seed)
        jnet = _mlp(jgluon)
        jnet.initialize()
    finally:
        np.random.set_state(state)
    tnet = _mlp(tgluon)
    tnet.initialize(ctx="cpu")
    tgluon.params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                                  jnet.collect_params().items()})
    return jnet, tnet


def _batch(seed=3, n=64):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 16).astype(np.float32)
    y = np.argmax(x @ rs.randn(16, 4).astype(np.float32), 1).astype(
        np.float32)
    return x, y


def _trainers(loss_kind="block", **kw):
    """The reference's and the port's trainer over the same MLP."""
    jnet, tnet = _mlps()
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    tl = tgluon.loss.SoftmaxCrossEntropyLoss()
    if loss_kind == "callable":
        jfn = lambda p, y: jl(nd.NDArray(p), nd.NDArray(y))._data  # noqa
        tfn = lambda p, y: tl(p, y)  # noqa: E731
    else:
        jfn, tfn = jl, tl
    jkw = dict(kw)
    if kw.get("compute_dtype") is not None:
        jkw["compute_dtype"] = jnp.bfloat16
    jt = JTrainer(jnet, jfn, mesh=None, donate=False, **jkw)
    tt = TTrainer(tnet, tfn, **kw)
    return jt, tt, jnet.prefix, tnet.prefix


def _pairs(jd, td, jpre, tpre):
    """(name, reference numpy array, port tensor) by stripped name."""
    assert len(jd) == len(td)
    tby = {k[len(tpre):]: v for k, v in td.items()}
    return [(k[len(jpre):], np.asarray(v), tby[k[len(jpre):]])
            for k, v in jd.items()]


def _assert_dicts_close(jd, td, jpre, tpre, what, **tol):
    for name, want, got in _pairs(jd, td, jpre, tpre):
        assert tuple(got.shape) == want.shape, (what, name)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=f"{what} {name}", **(tol or TOL))


@pytest.mark.parametrize("loss_kind", ["block", "callable"])
def test_plain_steps_match_jax(loss_kind):
    jt, tt, jpre, tpre = _trainers(loss_kind, lr=LR, momentum=MOMENTUM)
    x, y = _batch()
    assert tt.residuals is None and jt.residuals is None
    for _ in range(3):
        lj, lt = float(jt.step(x, y)), tt.step(x, y)
        assert lt.dtype == torch.float32 and lt.ndim == 0
        np.testing.assert_allclose(float(lt), lj, rtol=1e-5)
        _assert_dicts_close(jt.params, tt.params, jpre, tpre, "param")
        _assert_dicts_close(jt.momenta, tt.momenta, jpre, tpre, "momentum")


def _copy_state(jt, tt, jpre, tpre):
    """Put the reference trainer's state into the port's."""
    for attr in ("params", "momenta", "residuals"):
        td = getattr(tt, attr)
        for name, want, _ in _pairs(getattr(jt, attr), td, jpre, tpre):
            td[tpre + name] = torch.from_numpy(np.array(want))


def _compressed_step_matches(jt, tt, jpre, tpre, x, y, t):
    """One compressed step from the same state on both sides: the loss;
    codes away from +-t exactly the reference's (so the momenta and
    parameters there), residuals everywhere.  Returns the count of
    elements near the threshold."""
    _copy_state(jt, tt, jpre, tpre)
    old_res = {k: v[0].clone() for k, v in tt.residuals.items()}
    _, grads, _ = tt._loss_and_grads(torch.from_numpy(x),
                                     torch.from_numpy(y))
    lj, lt = float(jt.step(x, y)), float(tt.step(x, y))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    near_total = 0
    for what in ("residuals", "momenta", "params"):
        for name, want, got in _pairs(getattr(jt, what), getattr(tt, what),
                                      jpre, tpre):
            k = tpre + name
            got = got.numpy()
            if what == "residuals":
                assert got.shape[0] == 1 == want.shape[0]
                got, want = got[0], want[0]
            g = (grads[k] + old_res[k]).numpy()
            near = np.abs(np.abs(g) - t) <= NEAR
            if what == "residuals":
                near_total += int(near.sum())
            far = ~near
            np.testing.assert_allclose(got[far], want[far], **TOL,
                                       err_msg=f"{what} {name}")
    return near_total


def test_compressed_steps_match_jax():
    t = 0.02
    jt, tt, jpre, tpre = _trainers(
        lr=LR, momentum=MOMENTUM,
        compression_params={"type": "2bit", "threshold": t})
    x, y = _batch()
    n = sum(v.numel() for v in tt.params.values())
    near = [_compressed_step_matches(jt, tt, jpre, tpre, x, y, t)
            for _ in range(3)]
    print(f"elements within {NEAR} of the threshold, per step: {near} "
          f"of {n}")
    assert sum(near) <= n // 100
    # the codes really moved the parameters
    assert any(np.abs(np.asarray(v)).max() > 0 for v in jt.momenta.values())


def test_threshold_blocks_update():
    """tests/test_gradient_compression.py's threshold-1e9 case without its
    mesh: every code is 0, so the step leaves every parameter unchanged
    and the whole gradient in the residual (leading axis 1), equal to the
    reference's."""
    jt, tt, jpre, tpre = _trainers(
        lr=0.5, compression_params={"type": "2bit", "threshold": 1e9})
    before = {k: v.clone() for k, v in tt.params.items()}
    rs = np.random.RandomState(1)
    x = rs.rand(16, 16).astype(np.float32)
    y = rs.randint(0, 4, (16,)).astype(np.float32)
    jt.step(x, y)
    tt.step(x, y)
    for k, v in tt.params.items():
        assert torch.equal(v, before[k]), k
    assert all(v.shape[0] == 1 for v in tt.residuals.values())
    assert any(v.abs().max() > 0 for v in tt.residuals.values())
    _assert_dicts_close(jt.residuals, tt.residuals, jpre, tpre, "residual")


def test_compressed_trains():
    """tests/test_gradient_compression.py's training case without its
    mesh: 60 compressed steps at threshold 0.02 cut the loss below 0.6 of
    its start; the residuals are live, one device deep."""
    _, tt, _, _ = _trainers(
        "callable", lr=0.05, momentum=0.9,
        compression_params={"type": "2bit", "threshold": 0.02})
    x, y = _batch()
    losses = [float(tt.step(x, y)) for _ in range(60)]
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
    assert tt.residuals is not None
    for k, v in tt.residuals.items():
        assert tuple(v.shape) == (1,) + tuple(tt.params[k].shape)
    assert any(v.abs().max() > 0 for v in tt.residuals.values())


def test_type_none_is_the_plain_step():
    _, tt, _, _ = _trainers(compression_params={"type": "none"})
    assert tt.residuals is None


@pytest.mark.parametrize("kind", ["weight_decay", "update_fn"])
def test_weight_decay_and_update_fn_match_jax(kind):
    if kind == "weight_decay":
        jkw = tkw = dict(lr=LR, momentum=MOMENTUM, weight_decay=0.01)
    else:
        def jupd(p, m, g):
            return ({k: p[k] - 0.1 * g[k] for k in p},
                    {k: 0.5 * m[k] + g[k] for k in m})

        def tupd(p, m, g):
            return ({k: p[k] - 0.1 * g[k] for k in p},
                    {k: 0.5 * m[k] + g[k] for k in m})

        jkw, tkw = dict(update_fn=jupd), dict(update_fn=tupd)
    jnet, tnet = _mlps()
    jt = JTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), mesh=None,
                  donate=False, **jkw)
    tt = TTrainer(tnet, tgluon.loss.SoftmaxCrossEntropyLoss(), **tkw)
    x, y = _batch()
    for _ in range(2):
        np.testing.assert_allclose(float(tt.step(x, y)),
                                   float(jt.step(x, y)), rtol=1e-5)
    _assert_dicts_close(jt.params, tt.params, jnet.prefix, tnet.prefix,
                        "param")
    _assert_dicts_close(jt.momenta, tt.momenta, jnet.prefix, tnet.prefix,
                        "momentum")


def test_bf16_compute_matches_jax():
    jt, tt, jpre, tpre = _trainers(lr=LR, momentum=MOMENTUM,
                                   compute_dtype=torch.bfloat16)
    p0 = {k: np.asarray(v) for k, v in jt.params.items()}
    x, y = _batch()
    lj, lt = float(jt.step(x, y)), float(tt.step(x, y))
    assert abs(lt - lj) <= 2e-2 * abs(lj)
    for name, want, got in _pairs(jt.params, tt.params, jpre, tpre):
        assert got.dtype == torch.float32   # f32 masters
        dj = want - p0[jpre + name]
        dt = got.numpy() - p0[jpre + name]
        assert np.linalg.norm(dt - dj) <= 5e-2 * np.linalg.norm(dj), name


def test_write_back_and_inputs():
    jt, tt, jpre, tpre = _trainers(lr=LR, momentum=MOMENTUM)
    x, y = _batch()
    for _ in range(2):
        jt.step(x, y)
        tt.step(torch.from_numpy(x), torch.from_numpy(y))   # tensors too
    block = tt._block
    pd = block.collect_params()
    trained = {k: v.clone() for k, v in tt.params.items()}
    assert not any(torch.equal(pd[k].data()._data, v)
               for k, v in trained.items())
    tt.write_back()
    jt.write_back()
    for k, v in trained.items():
        assert torch.equal(pd[k].data()._data, v), k
    jpd = jt._block.collect_params()
    for name, want, got in _pairs({k: jpd[k].data().asnumpy()
                                   for k in jt.params},
                                  {k: pd[k].data()._data.detach()
                                   for k in trained},
                                  jpre, tpre):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)
    # float64 numpy input is taken as float32, as the reference's is
    assert np.isfinite(float(tt.step(x.astype(np.float64), y)))


def test_mesh_is_not_ported():
    _, tnet = _mlps()
    with pytest.raises(MXNetError, match="mesh"):
        TTrainer(tnet, tgluon.loss.SoftmaxCrossEntropyLoss(), mesh=object())


def _small_resnets():
    """A small channels-last ResNet v1 in both packages (BatchNorms at C =
    16, 128 and 256: the reference's Pallas kernels at the last two), the
    port's parameters carried from the reference's."""
    def build(vision):
        return vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 128, 256],
                               classes=10, thumbnail=True, layout="NHWC")

    state = np.random.get_state()
    try:
        np.random.seed(4)
        jnet = build(jgluon.model_zoo.vision)
        jnet.initialize()
        jnet(nd.array(np.zeros((1, 16, 16, 3), np.float32)))
    finally:
        np.random.set_state(state)
    tnet = build(tgluon.model_zoo.vision)
    tnet.initialize(ctx="cpu")
    tnet(torch.zeros(1, 16, 16, 3))
    tgluon.params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                                  jnet.collect_params().items()})
    return jnet, tnet


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_resnet_compressed_step_matches_jax(monkeypatch):
    """One compressed step of a small channels-last ResNet v1 (B = 2,
    16x16) with the reference's BatchNorm kernels on
    (``MXTPU_BN_PALLAS=1``): the loss (rtol 1e-5), every residual 1e-4
    normwise (a conv bias feeding a BatchNorm has an analytically zero
    gradient: both residuals are held to zero there), the codes — so the
    momenta and parameters — exact away from +-t, the new running
    statistics rtol 1e-5 / atol 1e-6."""
    monkeypatch.setenv("MXTPU_BN_PALLAS", "1")
    t = 0.01
    jnet, tnet = _small_resnets()
    comp = {"type": "2bit", "threshold": t}
    jt = JTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), lr=0.1,
                  momentum=0.9, mesh=None, donate=False,
                  compression_params=comp)
    tt = TTrainer(tnet, tgluon.loss.SoftmaxCrossEntropyLoss(), lr=0.1,
                  momentum=0.9, compression_params=comp)
    jpre, tpre = jnet.prefix, tnet.prefix
    rs = np.random.RandomState(6)
    x = (rs.randn(2, 16, 16, 3) * 1.5 + 0.3).astype(np.float32)
    y = rs.randint(0, 10, 2).astype(np.float32)
    _, grads, _ = tt._loss_and_grads(torch.from_numpy(x),
                                     torch.from_numpy(y))
    launches = (tb.twobit_pack.launches, tb.twobit_unpack.launches)
    lj, lt = float(jt.step(x, y)), float(tt.step(x, y))
    # CPU tensors take the plain versions: no kernel launch counted
    assert (tb.twobit_pack.launches, tb.twobit_unpack.launches) == launches
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    res = _pairs(jt.residuals, tt.residuals, jpre, tpre)
    top = max(np.linalg.norm(w) for _, w, _ in res)
    near_total, codes = 0, 0
    for name, want, got in res:
        want, got = want[0], got[0].numpy()
        if np.linalg.norm(want) < 1e-6 * top:
            assert "conv2d" in name and name.endswith("bias"), name
            assert np.linalg.norm(got) < 1e-6 * top, name
        else:
            assert _normwise(got, want) <= 1e-4, name
        near = np.abs(np.abs(grads[tpre + name].numpy()) - t) <= NEAR
        near_total += int(near.sum())
        for what in ("momenta", "params"):
            w = np.asarray(getattr(jt, what)[jpre + name])
            g = getattr(tt, what)[tpre + name].numpy()
            np.testing.assert_allclose(g[~near], w[~near], **TOL,
                                       err_msg=f"{what} {name}")
        codes += int((np.asarray(jt.momenta[jpre + name]) != 0).sum())
    n = sum(v.numel() for v in tt.params.values())
    print(f"elements within {NEAR} of the threshold: {near_total} of {n}; "
          f"nonzero codes {codes}")
    assert near_total <= n // 100 and codes > 0
    _assert_dicts_close(jt.aux, tt.aux, jpre, tpre, "aux",
                        rtol=1e-5, atol=1e-6)
