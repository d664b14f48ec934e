"""PyTorch port: the transformer LM against the JAX package.

Same parameters (the JAX initializer's, carried across by
``params_from_jax``), same numpy tokens.  The full-sequence forward and a
prefill + 4 decode-step chain through ``transformer_lm_decode`` — the
gather path and the paged path (its CPU plain version) — are held against
the JAX ``transformer_lm_decode`` (gather path): logits at rtol 1e-4 /
atol 1e-5 (XLA:CPU and torch order their matmul sums differently), the
pools on every written position at the same tolerance.

The int8 pool: the quantizing scatter is held bitwise against the
reference's from identical numpy pools, scales and values (block 0, where
duplicate targets land, excepted); a prefill + two decode steps through
int8 pools, paged and gather, match the JAX function's logits at rtol
1e-4 and the layer-0 pool writes bitwise.
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


# -- the int8 pool --------------------------------------------------------------------
_NB, _H, _D = 12, 3, 8


def _scatter_case(kind):
    """(T, positions, lengths, tables) of one scatter case; pools hold
    random int8 bits and scales, so every block starts with stale data."""
    if kind == "decode":       # T=1, one row at a block boundary, one idle
        return 1, [[5], [8], [0]], [1, 1, 0], [[1, 2, 0], [3, 4, 5],
                                               [0, 0, 0]]
    if kind == "prefill":      # a chunk spanning three blocks, 6 valid
        return 8, [list(range(2, 10))], [6], [[6, 7, 8, 0]]
    if kind == "partial_tail":  # the chunk ends inside its last block
        return 8, [list(range(8, 16))], [5], [[6, 7, 8, 9, 10]]
    # a reused block (stale bits and scale) receiving its first write,
    # beside a row whose blocks all lie past its last valid position
    return 4, [list(range(4, 8)), list(range(0, 4))], [2, 0], \
        [[9, 11, 0], [3, 0, 0]]


@pytest.mark.parametrize("kind", ["decode", "prefill", "partial_tail",
                                  "reused_block"])
def test_scatter_kv_quantized_bitwise(kind):
    T, positions, lengths, tables = _scatter_case(kind)
    rs = np.random.RandomState(len(kind))
    pool = rs.randint(-127, 128, (_NB, BS, _H, _D)).astype(np.int8)
    scale = (rs.rand(_NB, _H) * 0.1 + 0.01).astype(np.float32)
    vals = rs.randn(len(lengths), T, _H, _D).astype(np.float32)
    positions = np.asarray(positions, np.int32)
    tables = np.asarray(tables, np.int32)
    valid = np.arange(T)[None] < np.asarray(lengths)[:, None]
    max_pos = np.where(valid, positions, -1).max(1).astype(np.int32)
    nt = tt._touched_blocks(T, BS)
    assert nt == jt._touched_blocks(T, BS)
    jp, js = jt._scatter_kv_quantized(
        jnp.asarray(pool), jnp.asarray(scale), jnp.asarray(vals),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(valid),
        jnp.asarray(max_pos), nt)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    out = tt._scatter_kv_quantized(
        tp, ts, torch.from_numpy(vals), torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(valid),
        torch.from_numpy(max_pos), nt)
    assert out[0] is tp and out[1] is ts   # written in place
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], np.asarray(js)[1:])
    assert (tp.numpy()[1:] != pool[1:]).any()


def _int8_chain(pt, pj, kernel):
    """Prefill 7 of an 8-token chunk (blocks 1-2, table width 4), then two
    T=1 decode steps fed the JAX run's greedy tokens, through int8 pools:
    per step the port's and (``pj`` given) the reference's valid logits,
    and each package's final layer-0 pools and scales."""
    nb = 8
    d_head = DIMS["d_model"] // DIMS["n_heads"]
    shape = (DIMS["n_layers"], nb, BS, DIMS["n_heads"], d_head)
    sshape = (DIMS["n_layers"], nb, DIMS["n_heads"])
    kj = vj = jnp.zeros(shape, jnp.int8)
    ksj = vsj = jnp.ones(sshape, jnp.float32)
    kt, vt = torch.zeros(shape, dtype=torch.int8), \
        torch.zeros(shape, dtype=torch.int8)
    kst, vst = torch.ones(sshape), torch.ones(sshape)
    tables = np.array([[1, 2, 3, 0]], np.int32)
    seq = np.random.RandomState(2).randint(0, 61, 10).astype(np.int32)
    tokens, pos = seq[None, :8], np.arange(8, dtype=np.int32)[None]
    lens = np.array([7], np.int32)
    steps = []
    for step in range(3):
        lt, kt, vt, kst, vst = tt.transformer_lm_decode(
            pt, tokens, pos, lens, kt, vt, tables, TCFG,
            attention_kernel=kernel, k_scale=kst, v_scale=vst)
        lj = None
        if pj is not None:
            lj, kj, vj, ksj, vsj = jt.transformer_lm_decode(
                pj, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lens),
                kj, vj, jnp.asarray(tables), JCFG, attention_kernel=kernel,
                k_scale=ksj, v_scale=vsj)
            lj = np.asarray(lj)[0, :lens[0]]
        steps.append((lt.numpy()[0, :lens[0]], lj))
        p = 7 + step
        tokens, pos = seq[None, p:p + 1], np.array([[p]], np.int32)
        lens = np.array([1], np.int32)
    ours = [t.numpy()[0] for t in (kt, vt, kst, vst)]
    ref = None if pj is None else [np.asarray(t)[0] for t in
                                   (kj, vj, ksj, vsj)]
    return steps, ours, ref


@pytest.mark.parametrize("kernel", ["gather", "paged"])
def test_int8_decode_chain_matches_jax(params, kernel, monkeypatch):
    """The port's ``kernel`` path against the reference's same path (its
    Pallas int8 kernel through the interpreter for "paged").  Logits at
    rtol 1e-4 / atol 1e-5 as for the float pool.  The layer-0 K/V the two
    packages quantize come from XLA:CPU and torch matmuls that may differ
    in the last ulp, so a block's absmax scale may too (rtol 1e-6) and an
    int8 value sitting on a rounding boundary may move by one step."""
    monkeypatch.setenv("TPUMX_PALLAS_INTERPRET", "1")
    pj, _, pt = params
    steps, ours, ref = _int8_chain(pt, pj, kernel)
    for lt, lj in steps:
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)
    for a, b in zip(ours[:2], ref[:2]):       # int8 pools, block 0 aside
        assert np.abs(a[1:].astype(int) - b[1:].astype(int)).max() <= 1
    for a, b in zip(ours[2:], ref[2:]):       # scales
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-6, atol=0)


def test_int8_paged_and_gather_write_identical_layer0(params):
    """Within the port, the paged and gather paths write layer 0's int8
    pool and scales bit for bit (the scatter does not depend on the
    attention path), and their logits agree at rtol 1e-4."""
    _, _, pt = params
    paged = _int8_chain(pt, None, "paged")
    gather = _int8_chain(pt, None, "gather")
    for a, b in zip(paged[1], gather[1]):
        np.testing.assert_array_equal(a[1:], b[1:])
    for (lp, _), (lg, _) in zip(paged[0], gather[0]):
        np.testing.assert_allclose(lp, lg, rtol=1e-4, atol=1e-5)
