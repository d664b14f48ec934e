"""PyTorch port: the transformer LM against the JAX package.

Same parameters (the JAX initializer's, carried across by
``params_from_jax``), same numpy tokens.  The full-sequence forward and a
prefill + 4 decode-step chain through ``transformer_lm_decode`` — the
gather path and the paged path (its CPU plain version) — are held against
the JAX ``transformer_lm_decode`` (gather path): logits at rtol 1e-4 /
atol 1e-5 (XLA:CPU and torch order their matmul sums differently), the
pools on every written position at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
from mxnet_tpu_torch.ops.paged_attention import paged_attention
from mxnet_tpu_torch.parallel import transformer as tt

DIMS = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
JCFG = jt.TransformerConfig(**DIMS)
TCFG = tt.TransformerConfig(**DIMS)
BS = 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    pj = jt.transformer_lm_init(JCFG, jax.random.PRNGKey(0))
    pn = {k: np.asarray(v) for k, v in pj.items()}
    return pj, pn, tt.params_from_jax(pn, device="cpu")


def test_params_from_jax_round_trip(params):
    pj, pn, pt = params
    assert sorted(pt) == sorted(pn)
    for k, v in pn.items():
        assert pt[k].dtype == torch.float32 and pt[k].device.type == "cpu"
        np.testing.assert_array_equal(pt[k].numpy(), v)
    half = tt.params_from_jax(pn, device="cpu", dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())
    # the port's own initializer: same keys, shapes and dtypes
    own = tt.transformer_lm_init(TCFG, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in pn.items()}
    again = tt.transformer_lm_init(TCFG, seed=3, device="cpu")
    assert all(torch.equal(own[k], again[k]) for k in own)


def test_apply_matches_jax(params):
    pj, _, pt = params
    toks = np.random.RandomState(0).randint(0, 61, (2, 11)).astype(np.int32)
    want = np.asarray(jt.transformer_lm_apply(pj, jnp.asarray(toks),
                                              jnp.arange(11), JCFG))
    got = tt.transformer_lm_apply(pt, torch.from_numpy(toks),
                                  torch.arange(11), TCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["gather", "paged"])
def test_decode_chain_matches_jax(params, kernel):
    pj, _, pt = params
    nb = 16
    shape = (DIMS["n_layers"], nb, BS, DIMS["n_heads"],
             DIMS["d_model"] // DIMS["n_heads"])
    kj, vj = jnp.zeros(shape), jnp.zeros(shape)
    kt, vt = torch.zeros(shape), torch.zeros(shape)
    # row 0: 6-token prompt in blocks 1,2,3; row 1: 8 tokens in 4..7
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    seq = np.random.RandomState(1).randint(0, 61, (2, 8)).astype(np.int32)
    T = 8
    tokens, lens = seq, np.array([6, 8], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    written = [list(range(6)), list(range(8))]
    ln0, pa0 = layer_norm_fused.launches, paged_attention.launches
    for step in range(5):
        lj, kj, vj = jt.transformer_lm_decode(
            pj, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lens),
            kj, vj, jnp.asarray(tables), JCFG, attention_kernel="gather")
        lt, kt, vt = tt.transformer_lm_decode(
            pt, tokens, pos, lens, kt, vt, tables, TCFG,
            attention_kernel=kernel)
        lj = np.asarray(lj)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        for b in range(2):
            n = lens[b]
            np.testing.assert_allclose(lt.numpy()[b, :n], lj[b, :n],
                                       rtol=1e-4, atol=1e-5)
        # next step: each row feeds its greedy token at the next position
        nxt = np.array([lj[b, lens[b] - 1].argmax() for b in range(2)],
                       np.int32)
        new_pos = np.array([pos[b, lens[b] - 1] + 1 for b in range(2)],
                           np.int32)
        for b in range(2):
            written[b].append(int(new_pos[b]))
        tokens, pos = nxt[:, None], new_pos[:, None]
        lens = np.array([1, 1], np.int32)
    # the last step's write is not in either pool yet; compare the rest
    kjn, vjn = np.asarray(kj), np.asarray(vj)
    for b in range(2):
        for p in written[b][:-1]:
            blk, off = tables[b, p // BS], p % BS
            np.testing.assert_allclose(kt.numpy()[:, blk, off],
                                       kjn[:, blk, off], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(vt.numpy()[:, blk, off],
                                       vjn[:, blk, off], rtol=1e-4,
                                       atol=1e-5)
    # CPU tensors run the plain versions: no kernel launch counted
    assert (layer_norm_fused.launches, paged_attention.launches) == \
        (ln0, pa0)


def test_decode_rejects_unknown_kernel(params):
    _, _, pt = params
    k = torch.zeros(2, 4, BS, 4, 8)
    with pytest.raises(ValueError, match="attention_kernel"):
        tt.transformer_lm_decode(pt, [[1]], [[0]], [1], k, k.clone(),
                                 [[1]], TCFG, attention_kernel="flash")
