"""PyTorch port, kernels 3-4: train-mode BatchNorm over the channel-last
axis against the JAX package.

The port's ``bn_train_fused`` on CPU tensors runs its plain version,
``bn_train_reference``; the JAX ``bn_train_fused`` runs its Pallas stats
and normalize kernels through the interpreter off-TPU (M a multiple of 8)
or its jnp reference (odd M).  Same numpy inputs, f32 and bf16 (x, gamma
and beta in bf16, as the bf16 training step casts them), C = 64, 128 and
256.  Tolerances: f32 rtol 1e-5 / atol 1e-5 (the two sum in different
orders, and the Pallas path normalizes as ``x * scale + shift`` where the
plain version computes ``(x - mean) * scale + beta``); bf16 outputs and
gradients within one bf16 ulp beyond that f32 tolerance (both compute in
f32 and round once), mean and var (f32 in both) at the f32 tolerance.
The gradients: ``jax.vjp`` of the JAX custom vjp (the vjp of its
``_bn_train_reference``) against torch autograd, for all three outputs'
cotangents.  The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import batch_norm as tbn
from mxnet_tpu_torch.ops import nn as tnn

F32_TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(shape, seed, offset=0.5, scale=2.0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * scale + offset).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    return x, g, b


def _assert_bf16_close(got, want, name):
    """Within one bf16 ulp of ``want`` beyond the f32 tolerance."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    beyond = np.abs(got - want) - F32_TOL["atol"] \
        - F32_TOL["rtol"] * np.abs(want)
    assert (beyond <= ulp).all(), (name, float((beyond / ulp).max()))


def _to_jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16) if bf16 else jnp.asarray(a)


def _to_torch(a, bf16):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if bf16 else t


CASES = [(dt, c, shape) for dt in ("float32", "bfloat16")
         for c in (64, 128, 256)
         for shape in ((2, 4, 8), (1, 37, 1))]


@pytest.mark.parametrize("dtype,c,lead", CASES,
                         ids=[f"{d}-C{c}-M{int(np.prod(s))}"
                              for d, c, s in CASES])
def test_bn_train_matches_jax(dtype, c, lead):
    bf16 = dtype == "bfloat16"
    x, g, b = _inputs(lead + (c,), c + int(np.prod(lead)))
    rs = np.random.RandomState(c)
    dy = rs.randn(*x.shape).astype(np.float32)
    dmean = rs.randn(c).astype(np.float32)
    dvar = rs.randn(c).astype(np.float32)

    jargs = [_to_jax(a, bf16) for a in (x, g, b)]
    (jout, jmean, jvar), vjp = jax.vjp(
        lambda *a: pk.bn_train_fused(*a, EPS, x.ndim - 1), *jargs)
    jgrads = vjp((_to_jax(dy, bf16), jnp.asarray(dmean), jnp.asarray(dvar)))

    leaves = [_to_torch(a, bf16).requires_grad_() for a in (x, g, b)]
    before = (tbn.bn_stats.launches, tbn.bn_normalize.launches)
    out, mean, var = tbn.bn_train_fused(*leaves, EPS)
    # the CPU path is the plain version: no kernel launch counted
    assert (tbn.bn_stats.launches, tbn.bn_normalize.launches) == before
    assert out.dtype == leaves[0].dtype and out.shape == x.shape
    assert mean.dtype == var.dtype == torch.float32
    tgrads = torch.autograd.grad(
        (out, mean, var), leaves,
        (_to_torch(dy, bf16), torch.from_numpy(dmean),
         torch.from_numpy(dvar)))

    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                               **F32_TOL)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(jvar),
                               **F32_TOL)
    pairs = [("out", out, jout)] + list(zip(("dx", "dgamma", "dbeta"),
                                             tgrads, jgrads))
    for name, t, j in pairs:
        got = t.detach().float().numpy()
        want = np.asarray(j, np.float32)
        if bf16:
            assert t.dtype == torch.bfloat16, name
            _assert_bf16_close(got, want, name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)


def test_bn_train_pivot_keeps_large_offset_exact():
    """mean/std ~ 1e3: the row-0 pivot keeps E[x^2] - mean^2 from
    cancelling; var matches a float64 two-pass variance."""
    x, g, b = _inputs((4, 4, 4, 128), 3, offset=1e3, scale=1.0)
    got_out, got_mean, got_var = tbn.bn_train_fused(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), EPS)
    want = pk.bn_train_fused(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             EPS, 3)
    x64 = x.reshape(-1, 128).astype(np.float64)
    np.testing.assert_allclose(got_var.numpy(), x64.var(axis=0), rtol=1e-4)
    np.testing.assert_allclose(got_mean.numpy(), x64.mean(axis=0),
                               rtol=1e-7)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want[1]),
                               rtol=1e-7)
    # the Pallas path's shift form x * scale + shift cancels at this
    # offset (|x * scale| ~ 1e3): compare out at that form's rounding
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want[0]),
                               rtol=0, atol=3e-4)


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_ops_batch_norm_channels_last_matches_jax(monkeypatch, c, fix_gamma):
    """``ops.nn.batch_norm``'s channels-last training path against the
    reference op with its kernels on (C = 128) and on its jnp path (C =
    64, where the reference's C % 128 gate keeps the kernel off)."""
    monkeypatch.setenv("MXTPU_BN_PALLAS", "1")
    x, g, b = _inputs((2, 4, 4, c), 20 + c)
    rm = np.zeros(c, np.float32)
    rv = np.ones(c, np.float32)
    kw = dict(eps=EPS, fix_gamma=fix_gamma, output_mean_var=True, axis=-1)
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, rm, rv)),
                          _training=True, **kw)
    got = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, rm, rv)),
                         _training=True, **kw)
    for name, t, j in zip(("out", "mean", "var"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **F32_TOL)


@pytest.mark.parametrize("c", [64, 128])
def test_ops_batch_norm_transposed_view_matches_jax(monkeypatch, c):
    """NCHW data viewed channels-last, ``F.transpose(x, axes=(0, 2, 3,
    1))``, through both packages' ``BatchNorm`` op with ``axis=3``.  The
    port's transpose is a view, not contiguous, so the op copies it (one
    count in ``batch_norm.noncontiguous_copies``) and gives the
    reference's result (the reference's kernels at C = 128, its jnp path
    at C = 64); the contiguous input makes no copy."""
    from mxnet_tpu.ops import tensor as jtensor
    from mxnet_tpu_torch import ndarray as tnd

    monkeypatch.setenv("MXTPU_BN_PALLAS", "1")
    monkeypatch.setattr(tnn.batch_norm, "noncontiguous_copies", 0)
    xl, g, b = _inputs((2, 4, 4, c), 70 + c)
    x = np.ascontiguousarray(xl.transpose(0, 3, 1, 2))   # NCHW
    rm = np.zeros(c, np.float32)
    rv = np.ones(c, np.float32)
    kw = dict(eps=EPS, fix_gamma=False, output_mean_var=True, axis=3)
    want = jnn.batch_norm(jtensor.transpose(jnp.asarray(x), axes=(0, 2, 3, 1)),
                          *(jnp.asarray(a) for a in (g, b, rm, rv)),
                          _training=True, **kw)
    view = tnd.transpose(torch.from_numpy(x), axes=(0, 2, 3, 1))
    assert not view.is_contiguous()
    got = tnd.BatchNorm(view, *(torch.from_numpy(a) for a in (g, b, rm, rv)),
                        _training=True, **kw)
    assert tnn.batch_norm.noncontiguous_copies == 1
    for name, t, j in zip(("out", "mean", "var"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **F32_TOL)
    tnd.BatchNorm(torch.from_numpy(xl), *(torch.from_numpy(a)
                                          for a in (g, b, rm, rv)),
                  _training=True, **kw)
    assert tnn.batch_norm.noncontiguous_copies == 1


@pytest.mark.parametrize("training", [True, False])
def test_ops_batch_norm_channels_first_matches_jax(training):
    """NCHW training (the plain pivot path) and inference (running
    statistics) BatchNorm, which stay plain torch ops."""
    x, g, b = _inputs((2, 8, 3, 5), 31)
    x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))   # (2, 5, 8, 3)
    c = 5
    rs = np.random.RandomState(32)
    rm = (0.1 * rs.randn(c)).astype(np.float32)
    rv = (1.0 + 0.2 * rs.rand(c)).astype(np.float32)
    kw = dict(eps=1e-3, fix_gamma=False, output_mean_var=True, axis=1,
              use_global_stats=not training)
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, rm, rv)),
                          _training=training, **kw)
    got = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, rm, rv)),
                         _training=training, **kw)
    for name, t, j in zip(("out", "mean", "var"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_and_normalize_match_pallas_kernels(dtype):
    """The two wrappers' plain versions against the Pallas kernels alone
    (``_bn_stats_call`` / ``_bn_norm_call`` in interpret mode)."""
    bf16 = dtype == "bfloat16"
    x, g, b = _inputs((64, 128), 40)
    xj = _to_jax(x, bf16)
    pivot = xj[0].astype(jnp.float32)
    s1, s2 = pk._bn_stats_call(xj, pivot, 16, True)
    mean_c = s1 / 64.0
    jvar = jnp.maximum(s2 / 64.0 - mean_c * mean_c, 0.0)
    mean, var = tbn.bn_stats(_to_torch(x, bf16))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_c + pivot),
                               **F32_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **F32_TOL)

    scale = (g / np.sqrt(var.numpy() + EPS)).astype(np.float32)
    shift = (b - mean.numpy() * scale).astype(np.float32)
    want = pk._bn_norm_call(xj, jnp.asarray(scale), jnp.asarray(shift), 16,
                            True)
    got = tbn.bn_normalize(_to_torch(x, bf16), torch.from_numpy(scale),
                           torch.from_numpy(shift))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    # same formula, one f32 rounding apart (fma or not)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2 if bf16 else 1e-6, atol=1e-6)


def test_function_backward_is_reference_vjp(monkeypatch):
    """The Function the CUDA path runs: its backward recomputes the plain
    version from the saved inputs and differentiates it for all three
    outputs (its forward is the kernels, stood in for here by the plain
    version)."""
    monkeypatch.setattr(tbn, "_launch", tbn.bn_train_reference)
    x, g, b = _inputs((3, 2, 5, 64), 50)
    rs = np.random.RandomState(51)
    cot = (torch.from_numpy(rs.randn(*x.shape).astype(np.float32)),
           torch.from_numpy(rs.randn(64).astype(np.float32)),
           torch.from_numpy(rs.randn(64).astype(np.float32)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, g, b)]
    outs = tbn._BatchNormFn.apply(*leaves, EPS)
    assert all(o.grad_fn is not None for o in outs)
    got = torch.autograd.grad(outs, leaves, cot)
    want = torch.autograd.grad(tbn.bn_train_reference(*leaves, EPS), leaves,
                               cot)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("c,itemsize,aligned,want", [
    (64, 2, True, (8, 8, 1, 32)),      # the stem, bf16: 8 rows of 128 B
    (2048, 2, True, (8, 32, 8, 8)),    # stage 4, bf16
    (64, 4, True, (4, 16, 1, 16)),     # the stem, f32
    (3, 4, True, (1, 4, 1, 64)),       # C no multiple of a vector
    (256, 2, False, (1, 32, 8, 8)),    # unaligned: scalar loads
])
def test_tiling(c, itemsize, aligned, want):
    assert tbn.tiling(c, itemsize, aligned) == want


@pytest.mark.parametrize("m,c", [(128 * 112 * 112, 64),
                                 (128 * 7 * 7, 2048), (12345, 320),
                                 (1, 64), (37, 3)])
def test_stats_splits_cover_every_row_once(m, c):
    _, _, tiles, step = tbn.tiling(c, 2)
    splits, rows = tbn.stats_splits(m, tiles, step)
    assert (splits - 1) * rows < m <= splits * rows
    assert splits * tiles <= tbn.STATS_BLOCKS + tiles
    if splits > 1:
        assert rows >= step * tbn.MIN_ROWS_PER_THREAD // 2


def test_bn_train_fused_refuses_bad_inputs():
    x, g, b = (torch.from_numpy(a) for a in _inputs((4, 6, 8), 60))
    with pytest.raises(MXNetError, match="contiguous"):
        tbn.bn_train_fused(x.transpose(0, 1), g, b)
    with pytest.raises(MXNetError, match="gamma"):
        tbn.bn_train_fused(x, g[:4], b)
    with pytest.raises(MXNetError, match="unsupported device"):
        tbn.bn_train_fused(torch.empty(4, 8, device="meta"),
                           torch.empty(8, device="meta"),
                           torch.empty(8, device="meta"))
    with pytest.raises(MXNetError, match="unsupported device"):
        tbn.bn_stats(torch.empty(4, 8, device="meta"))
    with pytest.raises(MXNetError, match="unsupported device"):
        tbn.bn_normalize(torch.empty(4, 8, device="meta"),
                         torch.empty(8, device="meta"),
                         torch.empty(8, device="meta"))
