"""PyTorch port: paged attention (float pool and int8 pool) against the
JAX package.

The port's ``paged_attention`` on CPU tensors runs its plain version
(gather, dequantize for the int8 pool, dense attend with the kernel's
block skipping in the mask); the JAX ``paged_attention`` runs its Pallas
kernels (``_paged_kernel``, ``_paged_kernel_q``) through the interpreter
off-TPU.  Same numpy inputs, f32.  Cases: T=1 decode and T=8 prefill
chunks, ragged lengths, a null table entry inside a live range, null
entries past a row's blocks, and an inactive row (max_pos = -1) that is 0
in both; for the int8 pool also per-(block, head) scales that vary, and
block 0 with its scales poisoned with NaN, which neither version may
read.  rtol 1e-5 / atol 1e-6.  The CUDA kernels themselves are held
against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import paged_attention as jpa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as tpa

H, D, BS, NB, W = 4, 8, 4, 16, 5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(T, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(3, T, H, D).astype(np.float32)
    k_pool = rs.randn(NB, BS, H, D).astype(np.float32)
    v_pool = rs.randn(NB, BS, H, D).astype(np.float32)
    tables = np.array([[3, 7, 1, 0, 0],      # ragged, null past its blocks
                       [2, 9, 0, 5, 11],     # null entry mid-range
                       [4, 6, 8, 0, 0]],     # inactive row
                      np.int32)
    # row b's queries start at start[b]; lengths[b] of them are valid
    start = np.array([9 - T + 1 if T > 1 else 9, 19 - T + 1, 0])
    lengths = np.array([T if T == 1 else T - 2, T, 0])
    positions = (start[:, None] + np.arange(T)[None, :]).astype(np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    max_pos = np.where(valid, positions, -1).max(axis=1).astype(np.int32)
    return q, k_pool, v_pool, tables, positions, max_pos, lengths


@pytest.mark.parametrize("T", [1, 8])
def test_paged_attention_matches_jax_kernel(T):
    q, kp, vp, tables, pos, mp, lengths = _case(T, T)
    assert mp[2] == -1
    scale = tpa.attention_scale(D)
    assert scale == jpa.attention_scale(D)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(mp),
        scale=scale))
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(mp)).numpy()
    assert tpa.paged_attention.launches == before
    for b in range(2):
        n = lengths[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-5,
                                   atol=1e-6)
    # the inactive row emits exactly 0 in both
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("T", [1, 8])
def test_paged_attention_matches_gather_reference(T):
    """Row 0 (no null entry inside its range) against the reference's
    gather+dense path with the plain causal mask."""
    q, kp, vp, tables, pos, mp, lengths = _case(T, 100 + T)
    scale = tpa.attention_scale(D)
    k_ctx = kp[tables].reshape(3, W * BS, H, D)
    v_ctx = vp[tables].reshape(3, W * BS, H, D)
    mask = np.arange(W * BS)[None, None, :] <= pos[:, :, None]
    want = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k_ctx), jnp.asarray(v_ctx),
        jnp.asarray(mask), scale))
    got_ref = tpa.paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k_ctx),
        torch.from_numpy(v_ctx), torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got_ref, want, rtol=1e-5, atol=1e-6)
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(mp), scale=scale).numpy()
    n = lengths[0]
    np.testing.assert_allclose(got[0, :n], want[0, :n], rtol=1e-5,
                               atol=1e-6)


def _int8_pool(seed):
    """An int8 pool with varying per-(block, head) scales; block 0 (the
    null block) holds garbage and NaN scales."""
    rs = np.random.RandomState(seed)
    kp = rs.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
    vp = rs.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
    ks = (rs.rand(NB, H) * 0.05 + 0.001).astype(np.float32)
    vs = (rs.rand(NB, H) * 0.05 + 0.001).astype(np.float32)
    ks[0] = vs[0] = np.nan
    return kp, vp, ks, vs


@pytest.mark.parametrize("T", [1, 8])
def test_paged_attention_int8_matches_jax_kernel(T):
    q, _, _, tables, pos, mp, lengths = _case(T, 200 + T)
    kp, vp, ks, vs = _int8_pool(300 + T)
    scale = tpa.attention_scale(D)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(mp), scale=scale,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    before = (tpa.paged_attention.launches,
              tpa.paged_attention.launches_int8)
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(mp), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs)).numpy()
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.launches_int8) == before
    assert got.dtype == np.float32 and np.isfinite(got).all()
    for b in range(2):
        n = lengths[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-5,
                                   atol=1e-6)
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("T", [1, 8])
def test_paged_attention_int8_matches_dequantized_float(T):
    """The int8 pool against the float pool holding its dequantized
    values (what the reference's gather path attends to)."""
    q, _, _, tables, pos, mp, lengths = _case(T, 400 + T)
    kp, vp, ks, vs = _int8_pool(500 + T)
    kf = (kp.astype(np.float32) * ks[:, None, :, None]).astype(np.float32)
    vf = (vp.astype(np.float32) * vs[:, None, :, None]).astype(np.float32)
    t = torch.from_numpy
    got = tpa.paged_attention(t(q), t(kp), t(vp), t(tables), t(pos), t(mp),
                              k_scale=t(ks), v_scale=t(vs)).numpy()
    want = tpa.paged_attention(t(q), t(np.nan_to_num(kf)),
                               t(np.nan_to_num(vf)), t(tables), t(pos),
                               t(mp)).numpy()
    for b in range(3):
        n = lengths[b]
        np.testing.assert_array_equal(got[b, :n], want[b, :n])


def test_paged_attention_refuses_other_devices():
    q = torch.empty(1, 1, H, D, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        tpa.paged_attention(q, q, q, q, q, q)
    with pytest.raises(MXNetError, match="both k_scale and v_scale"):
        tpa.paged_attention(q, q, q, q, q, q, k_scale=q)
