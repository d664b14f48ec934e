"""PyTorch port: token sampling against the JAX package.

Keys (``fold_in(PRNGKey(seed), counter)``) must be bit-identical; the
Gumbel noise agrees at rtol 1e-6 with atol 1e-6 (the uniform bits are
identical, but torch's and XLA's f32 ``log`` may differ in the last ulp,
and ``-log(-log(u))`` crosses zero, where a relative bound alone cannot
hold); sampled tokens are identical for greedy, temperature, top-k and
top-p rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import sampling as js
from mxnet_tpu_torch.ops import sampling as ts

V = 61


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _grid():
    seeds = np.array([0, 1, 2, 7, 255, 12345, 2 ** 31 - 1, 2 ** 31,
                      2 ** 32 - 1], np.uint32)
    counters = np.array([0, 1, 3, 17, 64, 1000, 2 ** 16 + 1, 2 ** 31 + 3,
                         2 ** 32 - 2], np.uint32)
    s, c = np.meshgrid(seeds, counters, indexing="ij")
    return s.ravel(), c.ravel()


def test_fold_keys_bit_identical():
    seeds, counters = _grid()
    want = np.asarray(js.fold_keys(seeds, counters)).astype(np.int64)
    got = ts.fold_keys(seeds, counters).numpy()
    np.testing.assert_array_equal(got, want)


def test_threefry_bits_bit_identical():
    seeds, counters = _grid()
    keys = np.asarray(js.fold_keys(seeds, counters))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (V,)))(
        jnp.asarray(keys))).astype(np.int64)
    k = torch.from_numpy(keys.astype(np.int64))
    idx = torch.arange(V)[None, :]
    b0, b1 = ts.threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(idx), idx)
    np.testing.assert_array_equal((b0 ^ b1).numpy(), want)


def test_gumbel_matches_jax():
    seeds, counters = _grid()
    keys = np.asarray(js.fold_keys(seeds, counters))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
        jnp.asarray(keys)))
    got = ts.gumbel(torch.from_numpy(keys.astype(np.int64)), V).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_masks_and_temperature_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(5, V).astype(np.float32)
    ks = np.array([1, 3, 0, 70, 10], np.int32)
    ps = np.array([0.5, 0.9, 1.0, 0.0, 0.7], np.float32)
    temps = np.array([0.0, 0.5, 1.0, 2.0, -1.0], np.float32)
    lt = torch.from_numpy(logits)
    np.testing.assert_array_equal(ts.top_k_mask(lt, ks).numpy(),
                                  np.asarray(js.top_k_mask(logits, ks)))
    np.testing.assert_array_equal(ts.top_p_mask(lt, ps).numpy(),
                                  np.asarray(js.top_p_mask(logits, ps)))
    np.testing.assert_allclose(
        ts.temperature_scale(lt, temps).numpy(),
        np.asarray(js.temperature_scale(logits, temps)), rtol=1e-6)


@pytest.mark.parametrize("mode", ["greedy", "temperature", "top_k", "top_p",
                                  "mixed"])
def test_sample_logits_tokens_identical(mode):
    rs = np.random.RandomState(7)
    B = 16
    logits = (rs.randn(B, V) * 2.0).astype(np.float32)
    seeds = rs.randint(0, 2 ** 32, size=B, dtype=np.uint64).astype(np.uint32)
    counters = rs.randint(0, 4096, size=B).astype(np.uint32)
    temp = np.full(B, 0.0 if mode == "greedy" else 0.8, np.float32)
    top_k = np.full(B, 5 if mode == "top_k" else 0, np.int32)
    top_p = np.full(B, 0.6 if mode == "top_p" else 1.0, np.float32)
    if mode == "mixed":
        temp = rs.choice([0.0, 0.7, 1.3], size=B).astype(np.float32)
        top_k = rs.choice([0, 3, 40], size=B).astype(np.int32)
        top_p = rs.choice([1.0, 0.5, 0.9], size=B).astype(np.float32)
    want = np.asarray(js.sample_logits(logits, seeds, counters, temp, top_k,
                                       top_p))
    got = ts.sample_logits(torch.from_numpy(logits), seeds, counters,
                           torch.from_numpy(temp), torch.from_numpy(top_k),
                           torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    if mode != "greedy":
        # the draws are random: not every row takes its argmax
        assert (got != logits.argmax(axis=1)).any()
