"""PyTorch port, kernels 6-8: flash attention against the JAX package.

The port's ``flash_attention`` on CPU tensors runs its plain versions
through the same ``torch.autograd.Function`` the CUDA kernels sit in; the
JAX ``flash_attention`` runs its Pallas kernels through the interpreter,
with ``TPUMX_PALLAS=1`` so that its backward is the dQ and dK/dV kernels.
Same numpy inputs.  Outputs and lse at f32 rtol 1e-5 / atol 2e-5,
gradients at rtol 1e-4 / atol 5e-5 (``tests/test_flash_attention.py``'s
tolerances against its dense oracle).  The CUDA kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.parallel.ring_attention import local_attention

OUT_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=5e-5)

# (B, T, H, D, causal): T=40 and 200 are no multiple of any tile
FWD_CASES = [(2, 40, 2, 16, True), (2, 40, 2, 16, False),
             (1, 200, 2, 64, True), (1, 200, 3, 64, False),
             (2, 64, 3, 16, True)]
GRAD_CASES = [(2, 40, 2, 16, True), (2, 40, 2, 16, False),
              (1, 200, 2, 64, True), (1, 72, 3, 64, False)]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def pallas(monkeypatch):
    """The JAX side takes its Pallas backward kernels (read at trace
    time, so every JAX call happens inside the test)."""
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    assert jfa._use_pallas_bwd()


def _inputs(B, T, H, D, seed, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, D).astype(np.float32) for _ in range(n)]


def _jax_forward_with_lse(q, k, v, causal):
    """The JAX forward kernel with its lse output, at the block sizes
    ``flash_attention`` would pick: (out (B, T, H, D), lse (B*H, T))."""
    B, T, H, D = q.shape
    sel_q, sel_k = jfa.select_flash_blocks(D, jnp.float32)
    bq = sel_q if T >= sel_q else max(16, 1 << (T - 1).bit_length())
    bk = min(sel_k, bq)
    t_pad = jfa._pad_grid(T, bq, bk)
    to3 = lambda x: jfa._pad_to(  # noqa: E731
        jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D), t_pad)
    out, lse = jfa._fwd_call(to3(q), to3(k), to3(v), T, causal, bq, bk,
                             1.0 / math.sqrt(D), True, with_lse=True)
    out = np.asarray(out[:, :T]).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    return out, np.asarray(lse[:, :T])


@pytest.mark.parametrize("B,T,H,D,causal", FWD_CASES)
def test_forward_and_lse_match_jax(B, T, H, D, causal):
    q, k, v = _inputs(B, T, H, D, seed=T + D + int(causal))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
    want_out, want_lse = _jax_forward_with_lse(q, k, v, causal)
    np.testing.assert_allclose(want_out, want, **OUT_TOL)
    n0 = tfa.flash_attention_forward.launches
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tfa.flash_attention_forward(tq, tk, tv, causal)
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, **OUT_TOL)
    np.testing.assert_allclose(lse.reshape(B * H, T).numpy(), want_lse,
                               **OUT_TOL)
    np.testing.assert_array_equal(got.detach().numpy(), out.numpy())
    # CPU tensors take the plain version: no kernel launch counted
    assert tfa.flash_attention_forward.launches == n0


@pytest.mark.parametrize("B,T,H,D,causal", GRAD_CASES)
def test_gradients_match_jax_pallas_backward(pallas, B, T, H, D, causal):
    q, k, v, g = _inputs(B, T, H, D, seed=7 * T + D + int(causal), n=4)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = (tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **OUT_TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and a.shape == (B, T, H, D)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)
    assert (tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == counts


def test_backward_reference_is_the_two_kernel_versions():
    """The plain backward splits into the dQ and dK/dV kernels' plain
    versions exactly, from the forward's out and lse, and agrees with
    autograd through local_attention."""
    B, T, H, D = 2, 40, 2, 16
    q, k, v, g = map(torch.from_numpy, _inputs(B, T, H, D, seed=3, n=4))
    scale = 1.0 / math.sqrt(D)
    out, lse = tfa.flash_attention_forward_reference(q, k, v, True)
    dq, dk, dv = tfa.flash_attention_backward_reference(q, k, v, out, lse,
                                                        g, True)
    delta = tfa.flash_delta(out, g)
    assert delta.shape == (B, H, T) and delta.is_contiguous()
    args = (q, k, v, g, lse, delta, True, scale)
    assert torch.equal(dq, tfa.flash_attention_dq_reference(*args))
    dk2, dv2 = tfa.flash_attention_dkv_reference(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, tfa.flash_attention_dq(*args[:-1], scale=scale))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(local_attention(*leaves, causal=True),
                               leaves, g)
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_bf16_runs_and_approximates(pallas):
    B, T, H, D = 1, 72, 2, 16
    q, k, v, g = _inputs(B, T, H, D, seed=11, n=4)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(g).to(torch.bfloat16))
    assert all(d.dtype == torch.bfloat16 for d in grads)
    # against the f32 oracle, as the reference's own bf16 test
    oracle = local_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               oracle.numpy(), rtol=0.1, atol=0.1)
    # against the JAX bf16 kernels: the same f32 arithmetic on the same
    # bf16 inputs, rounded to bf16 at the end (within 2 bf16 ulps)
    jb = [jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)]
    out_j, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=True), *jb)
    want = vjp(jnp.asarray(g, dtype=jnp.bfloat16))
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(out_j, np.float32),
                               rtol=2e-2, atol=1e-2)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=2e-2,
                                   atol=2e-2)


def test_block_sizes_and_layouts_leave_result_unchanged():
    """block_q/block_k change nothing; strided views (the LM's split qkv
    product) and a non-contiguous output gradient give the same bits as
    contiguous tensors."""
    B, T, H, D = 2, 40, 2, 16
    qkv = torch.from_numpy(_inputs(B, T, 3 * H * D, 1, seed=5, n=1)[0]
                           ).reshape(B, T, 3 * H * D)
    views = [t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1)]
    assert not views[0].is_contiguous()
    dense = [t.contiguous() for t in views]
    base = tfa.flash_attention(*dense, causal=True)
    for bq, bk in ((16, 16), (128, 32), (None, 64)):
        assert torch.equal(tfa.flash_attention(*dense, causal=True,
                                               block_q=bq, block_k=bk), base)
    leaves = [t.clone().requires_grad_() for t in views]
    out = tfa.flash_attention(*leaves, causal=True)
    assert torch.equal(out, base)
    g = torch.from_numpy(_inputs(B, H, T, D, seed=6, n=1)[0])
    got = torch.autograd.grad(out, leaves, g.transpose(1, 2))
    ref_leaves = [t.clone().requires_grad_() for t in dense]
    want = torch.autograd.grad(tfa.flash_attention(*ref_leaves, causal=True),
                               ref_leaves, g.transpose(1, 2).contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch (device-independent):
    q, k and v sharing their strides pass as they are, mixed layouts are
    made contiguous, other head dims and dtypes raise."""
    B, T, H, D = 1, 8, 2, 16
    qkv = torch.zeros(B, T, 3 * H * D)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    q2, k2, v2 = tfa._check_qkv(q, k, v, "t")
    assert (q2.data_ptr(), k2.data_ptr()) == (q.data_ptr(), k.data_ptr())
    q3, _, v3 = tfa._check_qkv(q.contiguous(), k, v, "t")
    assert q3.is_contiguous() and v3.is_contiguous()
    bad_d = torch.zeros(B, T, H, 24)
    with pytest.raises(MXNetError, match="head dim"):
        tfa._check_qkv(bad_d, bad_d, bad_d, "t")
    half = torch.zeros(B, T, H, D, dtype=torch.float16)
    with pytest.raises(MXNetError, match="not supported"):
        tfa._check_qkv(half, half, half, "t")
    with pytest.raises(MXNetError, match="k must match"):
        tfa._check_qkv(q, torch.zeros(B, T + 1, H, D), v, "t")
    lse = torch.zeros(B, H, T)
    with pytest.raises(MXNetError, match="delta must be"):
        tfa._check_bwd(q, k, v, torch.zeros(B, T, H, D), lse,
                       lse.transpose(1, 2), "t")


def test_flash_attention_refuses_other_devices():
    x = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        tfa.flash_attention_forward(x, x, x)
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        tfa.flash_attention_dkv(x, x, x, x, lse, lse)
