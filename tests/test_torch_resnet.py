"""PyTorch port: a channels-last Gluon ResNet's training step against the
JAX package.

A small channels-last ResNet from the public constructors, v1 and v2
(``ResNetV*(Bottleneck*, [1, 1], [16, 128, 256], classes=10,
thumbnail=True, layout="NHWC")`` at B = 4, 16x16: BatchNorms at C = 3
(v2's input whitening), 16, 32 and 64 — the reference's jnp path — and
at 128 and 256, its Pallas kernel path).  The same parameters, running
statistics and momenta (numpy, from a seed) go into both packages (the
port's through ``params_from_jax``); one step of ``bench.py``'s
``make_step`` in f32 — ``log_softmax`` NLL mean, ``m = 0.9 m + g``,
``p = p - 0.1 m`` — over ``block_train_fn``, so the batch statistics
reach the running statistics.  (A conv bias feeding a training-mode
BatchNorm has an analytically zero gradient; there both sides are held to
zero, below 1e-6 of the largest gradient's norm.)  The JAX step is jitted
inside the test
with ``MXTPU_BN_PALLAS=1`` (monkeypatch), so its BatchNorms at C % 128 ==
0 run the Pallas kernels through the interpreter.  Tolerances: loss rtol
1e-5, every gradient 1e-4 normwise, the new parameters rtol 1e-5 /
atol 1e-6, the new momenta 1e-4 normwise, the new running statistics
rtol 1e-5 / atol 1e-6 (XLA:CPU and torch order their convolution sums
differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import gluon as jgluon, nd
from mxnet_tpu.parallel import data_parallel as jdp
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import batch_norm as tbn
from mxnet_tpu_torch.parallel import data_parallel as tdp

B, HW, CLASSES = 4, 16, 10
LR, MOMENTUM = 0.1, 0.9


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _build(vision, version):
    cls, block = {1: (vision.ResNetV1, vision.BottleneckV1),
                  2: (vision.ResNetV2, vision.BottleneckV2)}[version]
    return cls(block, [1, 1], [16, 128, 256], classes=CLASSES,
               thumbnail=True, layout="NHWC")


def _arrays(shapes, seed):
    """Parameters and running statistics for every name, from a seed."""
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


def _strip(d, prefix):
    assert all(k.startswith(prefix) for k in d)
    return {k[len(prefix):]: v for k, v in d.items()}


@pytest.fixture(scope="module", params=[1, 2], ids=["v1", "v2"])
def nets(request):
    """(JAX net, port net, the shared numpy parameters by stripped name)."""
    version = request.param
    state = np.random.get_state()   # the reference initializer draws here
    try:
        np.random.seed(0)
        jnet = _build(jgluon.model_zoo.vision, version)
        jnet.initialize()
        jnet(nd.array(np.zeros((1, HW, HW, 3), np.float32)))
    finally:
        np.random.set_state(state)
    jpd = jnet.collect_params()
    arrays = _arrays({k: p.shape for k, p in jpd.items()}, 10 + version)
    for k, p in jpd.items():
        p.set_data(nd.array(arrays[k]))
    tnet = _build(tgluon.model_zoo.vision, version)
    tnet.initialize(ctx="cpu")
    tnet(torch.zeros(1, HW, HW, 3))
    tgluon.params_from_jax(tnet, arrays)
    return jnet, tnet, _strip(arrays, jnet.prefix)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(5)
    x = (rs.randn(B, HW, HW, 3) * 1.5 + 0.3).astype(np.float32)
    y = rs.randint(0, CLASSES, B).astype(np.int32)
    return x, y


def _jax_step(apply_fn):
    """bench.py's make_step over block_train_fn, in f32."""

    def step(params, momenta, aux, x, y):
        def loss_of(p):
            out, new_aux = apply_fn(p, aux, x)
            logp = jax.nn.log_softmax(out.astype(jnp.float32))
            return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), \
                new_aux

        (loss, new_aux), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params)
        momenta = jax.tree_util.tree_map(lambda m, g: MOMENTUM * m + g,
                                         momenta, grads)
        params = jax.tree_util.tree_map(lambda p, m: p - LR * m, params,
                                        momenta)
        return loss, params, momenta, new_aux, grads

    return jax.jit(step)


def _torch_step(apply_fn, params, momenta, aux, x, y):
    """The same step in the port: autograd over block_train_fn."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out, new_aux = apply_fn(leaves, aux, x)
    logp = torch.log_softmax(out.float(), dim=-1)
    loss = -logp.gather(1, y[:, None].long()).mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        momenta = {k: MOMENTUM * momenta[k] + grads[k] for k in momenta}
        params = {k: params[k] - LR * momenta[k] for k in params}
    return loss.detach(), params, momenta, \
        {k: v.detach() for k, v in new_aux.items()}, grads


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_resnet_train_step_matches_jax(monkeypatch, nets, batch):
    monkeypatch.setenv("MXTPU_BN_PALLAS", "1")
    jnet, tnet, arrays = nets
    x, y = batch
    rs = np.random.RandomState(7)

    japply, jp, ja = jdp.block_train_fn(jnet, is_train=True)
    jmom = {k: (0.01 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in jp.items()}
    jloss, jp2, jm2, jaux2, jgrads = _jax_step(japply)(
        jp, {k: jnp.asarray(v) for k, v in jmom.items()}, ja,
        jnp.asarray(x), jnp.asarray(y))

    tapply, tp, ta = tdp.block_train_fn(tnet, is_train=True)
    jpre, tpre = jnet.prefix, tnet.prefix
    mom_by = _strip(jmom, jpre)
    tmom = {k: torch.from_numpy(mom_by[k[len(tpre):]]) for k in tp}
    launches = (tbn.bn_stats.launches, tbn.bn_normalize.launches)
    tloss, tp2, tm2, taux2, tgrads = _torch_step(
        tapply, tp, tmom, ta, torch.from_numpy(x), torch.from_numpy(y))
    # CPU tensors take the plain versions: no kernel launch counted
    assert (tbn.bn_stats.launches, tbn.bn_normalize.launches) == launches

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want, got = _strip(jgrads, jpre), _strip(tgrads, tpre)
    assert set(want) == set(got)
    # a conv bias feeding a training-mode BatchNorm has an analytically zero
    # gradient (the normalization removes any per-channel constant): both
    # sides give rounding noise there, held to zero instead of normwise
    top = max(np.linalg.norm(np.asarray(v)) for v in want.values())
    zero = {k for k, v in want.items()
            if np.linalg.norm(np.asarray(v)) < 1e-6 * top}
    assert all("conv2d" in k and k.endswith("bias") for k in zero)
    for k in want:
        if k in zero:
            assert np.linalg.norm(got[k].numpy()) < 1e-6 * top, k
        else:
            err = _normwise(got[k].numpy(), want[k])
            assert err <= 1e-4, ("grad", k, err)
    want, got = _strip(jm2, jpre), _strip(tm2, tpre)
    for k in want:
        err = _normwise(got[k].numpy(), want[k])
        assert err <= 1e-4, ("momentum", k, err)
    want, got = _strip(jp2, jpre), _strip(tp2, tpre)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want, got = _strip(jaux2, jpre), _strip(taux2, tpre)
    assert set(want) == set(got) and any("running_mean" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the functional call left the block's own tensors untouched
    own = _strip({k: p.data().asnumpy()
                  for k, p in tnet.collect_params().items()}, tpre)
    for k, v in own.items():
        assert np.array_equal(v, arrays[k]), k


def test_resnet_inference_matches_jax(nets, batch):
    """Predict mode (running statistics) through the eager blocks."""
    jnet, tnet, _ = nets
    x, _ = batch
    want = jnet(nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_eager_training_forward_updates_running_stats(nets, batch):
    """Outside a functional call, a training forward writes the running
    statistics in place, as the reference's layer does."""
    from mxnet_tpu_torch import autograd

    _, tnet, arrays = nets
    x, _ = batch
    bn = next(b for b in tnet.modules()
              if isinstance(b, tgluon.nn.BatchNorm) and b._scale)
    before = bn.running_mean.data().copy()._data
    state = {k: v.clone() for k, v in tnet.state_dict().items()}
    try:
        with autograd.record():
            tnet(torch.from_numpy(x))
        after = bn.running_mean.data()._data
        assert not torch.equal(before, after)
        assert after is bn.running_mean._var
    finally:
        tnet.load_state_dict(state)


def test_port_refuses_cuda_without_cuda(monkeypatch):
    """A CUDA request without CUDA raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = tgluon.model_zoo.vision.resnet18_v1(classes=10, layout="NHWC")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        net.initialize()
    with pytest.raises(MXNetError, match="not available"):
        net.initialize(ctx="cuda")
