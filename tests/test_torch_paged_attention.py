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
read.  rtol 1e-5 / atol 1e-6.  Further down, torch emulations of the CUDA
kernels' own arithmetic (decode spans merged in order, prefill 64-key
tiles) are held against the same JAX kernels, and bf16 inputs against the
JAX kernel in bf16.  The CUDA kernels themselves are held against the
plain version on the card by chip_smoke.py.
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


# -- the CUDA kernels' algebra, emulated on the CPU ---------------------------
# ``csrc/paged_attention.cu`` reorders the TPU kernels' arithmetic: decode
# cuts the context into spans of whole pool blocks, attends each span on its
# own and merges the partial (m, l, acc) states in span order; prefill
# streams 64-key tiles that straddle pool blocks (and int8 scales); the int8
# scales multiply each key's score and probability instead of each element.
# The emulations below do the same in f32 torch ops, span by span and tile
# by tile, and are held against the JAX Pallas kernels (interpreted).

SPAN = 128          # the .cu file's kSpan: positions a decode block holds
KEY_TILE = 64       # the prefill kernel's key (and query) tile


def _attend_rows(qs, qpos, k, v, kpos, live, ks, vs, state):
    """One online-softmax step of the kernels over rows k, v (f32 values
    of the pool's dtype) at cache positions kpos: scores ks * (q . k),
    -1e30 where the key is past the query, no key at all where not live;
    the value sum takes (p * vs) * v."""
    m, l, acc = state
    s = (qs @ k.T) * ks[None, :]
    s = torch.where(kpos[None, :] <= qpos[:, None], s,
                    torch.tensor(-1e30))
    s = torch.where(live[None, :], s, torch.tensor(-float("inf")))
    m_new = torch.maximum(m, s.max(dim=1).values)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    return (m_new, alpha * l + p.sum(dim=1),
            acc * alpha[:, None] + (p * vs[None, :]) @ v)


def _rows(pool, scale, blk, j, h, live):
    """Rows (blk, j) of head h as f32 with their per-key scales (1 for a
    float pool); dead rows are zeros with scale 0, never read."""
    blk = torch.where(live, blk, torch.zeros_like(blk))
    rows = torch.where(live[:, None], pool[blk, j, h].float(),
                       torch.tensor(0.0))
    if scale is None:
        return rows, torch.ones(len(blk))
    return rows, torch.where(live, scale[blk, h], torch.tensor(0.0))


def _decode_emulation(q, kp, vp, tables, pos, mp, scale, ks=None, vs=None,
                      span=SPAN):
    """paged_decode_split_kernel + paged_decode_merge_kernel."""
    B, T, H, D = q.shape
    bs, W = kp.shape[1], tables.shape[1]
    per = max(1, span // bs)
    out = torch.zeros(B, T, H, D)
    spans_seen = []
    for b in range(B):
        last = int(pos[b].max())
        blim = min(int(mp[b]), last)
        if blim < 0:
            continue            # span 0 writes the zeros
        n_live = (blim // bs) // per + 1
        for h in range(H):
            qs = q[b, :, h].float() * scale
            parts = []
            for s in range(n_live):
                ws = [w for w in range(s * per, min(W, (s + 1) * per))
                      if w <= blim // bs and int(tables[b, w]) != 0]
                if h == 0:
                    spans_seen.append((b, s, len(ws)))
                state = (torch.full((T,), -1e30), torch.zeros(T),
                         torch.zeros(T, D))
                rows = [(w, j) for w in ws for j in range(bs)
                        if w * bs + j <= last]
                for r0 in range(0, len(rows), SPAN):   # chunks of kSpan
                    w_, j_ = zip(*rows[r0:r0 + SPAN])
                    w_, j_ = torch.tensor(w_), torch.tensor(j_)
                    blk = tables[b].long()[w_]
                    live = torch.ones(len(w_), dtype=torch.bool)
                    k, kss = _rows(kp, ks, blk, j_, h, live)
                    v, vss = _rows(vp, vs, blk, j_, h, live)
                    state = _attend_rows(qs, pos[b].long(), k, v,
                                         w_ * bs + j_, live, kss, vss, state)
                parts.append(state)
            if n_live == 1:
                m, l, acc = parts[0]
                o = acc / torch.clamp(l, min=1e-30)[:, None]
            else:   # merged in span order
                M = torch.stack([p[0] for p in parts]).max(dim=0).values
                L, O = torch.zeros(T), torch.zeros(T, D)
                for m, l, acc in parts:
                    c = torch.exp(m - M)
                    L = L + c * l
                    O = O + c[:, None] * acc
                o = O / torch.clamp(L, min=1e-30)[:, None]
            out[b, :, h] = o
    return out, spans_seen


def _prefill_emulation(q, kp, vp, tables, pos, mp, scale, ks=None,
                       vs=None):
    """paged_prefill_tile_kernel: 64-query tiles, 64-key tiles gathered
    from the table row by row."""
    B, T, H, D = q.shape
    bs, W = kp.shape[1], tables.shape[1]
    out = torch.zeros(B, T, H, D)
    for b in range(B):
        for t0 in range(0, T, KEY_TILE):
            qp = pos[b, t0:t0 + KEY_TILE].long()
            last = int(qp.max())
            blim = min(int(mp[b]), last)
            kend = -1 if blim < 0 else min(last, W * bs - 1,
                                           (blim // bs) * bs + bs - 1)
            nt = kend // KEY_TILE + 1 if kend >= 0 else 0
            for h in range(H):
                qs = q[b, t0:t0 + KEY_TILE, h].float() * scale
                n = len(qp)
                state = (torch.full((n,), -1e30), torch.zeros(n),
                         torch.zeros(n, D))
                for kt in range(nt):
                    p = kt * KEY_TILE + torch.arange(KEY_TILE)
                    ok = p <= kend
                    w = torch.clamp(p // bs, max=W - 1)
                    blk = torch.where(ok, tables[b].long()[w],
                                      torch.zeros_like(w))
                    live = blk != 0
                    k, kss = _rows(kp, ks, blk, p % bs, h, live)
                    v, vss = _rows(vp, vs, blk, p % bs, h, live)
                    state = _attend_rows(qs, qp, k, v, p, live, kss, vss,
                                         state)
                m, l, acc = state
                out[b, t0:t0 + KEY_TILE, h] = \
                    acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def _kernel_emulation(q, kp, vp, tables, pos, mp, scale, ks=None, vs=None):
    """The route the wrapper's CUDA launch takes for T queries."""
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), t(tables), t(pos), t(mp), scale,
            None if ks is None else t(ks), None if vs is None else t(vs))
    if q.shape[1] <= 4:
        return _decode_emulation(*args)
    return _prefill_emulation(*args), None


def _long_case(T, bs, seed):
    """Four rows over W*bs = 320 positions (three decode spans): row 0
    a 300-position context; row 1 a null entry mid-table in its first
    span and its whole second span (positions 128..255) null, so that
    span has no live block; row 2 inactive (max_pos = -1); row 3 one span
    (37 positions).  For T > 1 the last two queries of row 0 are past
    max_pos.  Block 0 holds NaN, which no reader may touch."""
    rs = np.random.RandomState(seed)
    W, nb = 320 // bs, 2 * 320 // bs + 2
    q = rs.randn(4, T, H, D).astype(np.float32)
    kp = rs.randn(nb, bs, H, D).astype(np.float32)
    vp = rs.randn(nb, bs, H, D).astype(np.float32)
    kp[0] = vp[0] = np.nan
    perm = list(rs.permutation(nb - 1) + 1)
    ctx = [300, 290, 0, 37]
    tables = np.zeros((4, W), np.int32)
    for b, n in enumerate(ctx):
        if n:
            nblk = n // bs + 1
            tables[b, :nblk] = [perm.pop() for _ in range(nblk)]
    tables[1, 3] = 0
    tables[1, 128 // bs:256 // bs] = 0
    positions = (np.array(ctx)[:, None] - T + 1
                 + np.arange(T)[None, :]).astype(np.int32)
    lengths = np.array([T if T == 1 else T - 2, T, 0, T])
    valid = np.arange(T)[None, :] < lengths[:, None]
    max_pos = np.where(valid, positions, -1).max(axis=1).astype(np.int32)
    return q, kp, vp, tables, positions, max_pos, lengths


def _quantized(pool):
    """An int8 pool as the engine fills it (``_scatter_kv_quantized``):
    per-(block, head) scale absmax / 127, values rounded half to even;
    block 0 keeps garbage and NaN scales."""
    live = pool[1:]
    scale = (np.abs(live).max(axis=(1, 3)) / np.float32(127.0)).astype(
        np.float32)
    q8 = np.full(pool.shape, 77, np.int8)
    q8[1:] = np.clip(np.rint(live / scale[:, None, :, None]), -127, 127)
    scale = np.concatenate([np.full((1, pool.shape[2]), np.nan, np.float32),
                            scale])
    return q8, scale


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("pool", ["float", "int8"])
def test_kernel_algebra_matches_jax_kernel(T, bs, pool):
    """The decode (T <= 4: spans merged in order) and prefill (T = 8:
    64-key tiles over blocks of 4 and 16) arithmetic of the CUDA kernels
    against the JAX Pallas kernels, float and int8 pools."""
    q, kp, vp, tables, pos, mp, lengths = _long_case(T, bs, 600 + T + bs)
    ks = vs = None
    if pool == "int8":
        kp, ks = _quantized(kp)
        vp, vs = _quantized(vp)
    scale = tpa.attention_scale(D)
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs))
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(mp),
        scale=scale, **kw))
    got, spans = _kernel_emulation(q, kp, vp, tables, pos, mp, scale, ks,
                                   vs)
    got = got.numpy()
    if spans is not None:
        # (row, span, live blocks): row 0 three spans, all live; row
        # 1's second span empty; row 3 one span; row 2 none
        assert [(r, s) for r, s, n in spans if n] == [
            (0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (3, 0)]
        assert (1, 1, 0) in spans
    assert np.isfinite(got).all()
    for b in (0, 1, 3):
        n = lengths[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-5,
                                   atol=1e-6)
    assert not got[2].any() and not want[2].any()


def test_decode_splits_follow_the_span():
    """The wrapper sizes the split kernel's grid and workspace in whole
    pool blocks of at most 128 positions (one block when a block is
    longer)."""
    assert tpa.decode_splits(32, 32) == 8
    assert tpa.decode_splits(64, 16) == 8
    assert tpa.decode_splits(80, 4) == 3
    assert tpa.decode_splits(5, 256) == 5
    assert tpa.decode_splits(7, 48) == 4


@pytest.mark.parametrize("T", [1, 8])
def test_paged_attention_bf16_matches_jax_kernel(T):
    """bf16 q on a bf16 pool: the plain version keeps the probabilities in
    f32 for the value product, as the TPU kernel does, so the two agree to
    one bf16 rounding of the output."""
    q, kp, vp, tables, pos, mp, lengths = _case(T, 800 + T)
    kp[0] = vp[0] = np.nan
    scale = tpa.attention_scale(D)
    want = np.asarray(jpa.paged_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(mp),
        scale=scale).astype(jnp.float32))
    got = tpa.paged_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(mp)).float().numpy()
    for b in range(2):
        n = lengths[b]
        # one bf16 ulp of the larger magnitude: 2^-8 relative
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2 ** -8,
                                   atol=1e-6)
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("T", [1, 8])
def test_bf16_rounded_probabilities_miss_jax_kernel(T):
    """Why the plain version widens a bf16 context before the dense attend:
    the gather reference on the bf16 context itself rounds the
    probabilities to bf16 before the value product, and that puts row 0
    (no null entry inside its range) past one bf16 ulp of the JAX kernel,
    which the widened context stays within."""
    q, kp, vp, tables, pos, mp, lengths = _case(T, 800 + T)
    scale = tpa.attention_scale(D)
    want = np.asarray(jpa.paged_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(mp),
        scale=scale).astype(jnp.float32))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kp, vp))
    rows = torch.from_numpy(tables[:1]).long()
    mask = torch.from_numpy(
        np.arange(W * BS)[None, None, :] <= pos[:1, :, None])
    n = lengths[0]
    outs = {}
    for wide in (False, True):
        k_ctx, v_ctx = (p[rows].reshape(1, W * BS, H, D) for p in (kb, vb))
        if wide:
            k_ctx, v_ctx = k_ctx.float(), v_ctx.float()
        outs[wide] = tpa.paged_attention_reference(
            qb[:1], k_ctx, v_ctx, mask, scale).float().numpy()[0, :n]
    np.testing.assert_allclose(outs[True], want[0, :n], rtol=2 ** -8,
                               atol=1e-6)
    assert not np.allclose(outs[False], want[0, :n], rtol=2 ** -8,
                           atol=1e-6)
