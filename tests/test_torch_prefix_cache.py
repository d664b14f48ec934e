"""PyTorch port: prefix caching against the JAX package.

The chain hash must give the reference's bytes, and the same script of
``insert``/``acquire``/``peek``/``evict_blocks`` calls on both packages'
``PrefixCacheIndex`` (each over its own package's ``BlockAllocator``)
must give identical returns, refcounts, ``num_shared`` and stats.  On the
port's own service (CPU): a finished prompt's full blocks stay resident
and a sharer that appends to a fully cached prompt gets a copy-on-write
block, leaving the shared blocks' bits untouched; and greedy tokens are
bit-identical whether a prompt was prefilled from scratch or served from
cached blocks, for the float and the int8 pool.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.serving import generation as jg
from mxnet_tpu.serving.generation import prefix_cache as jpc
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import generation as tg
from mxnet_tpu_torch.serving.generation import prefix_cache as tpc

DIMS = dict(vocab=40, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
GEN = dict(max_slots=2, block_size=8, num_blocks=32, seq_buckets=[16, 32],
           max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    pj = jt.transformer_lm_init(jt.TransformerConfig(**DIMS),
                                jax.random.PRNGKey(0))
    return tt.params_from_jax({k: np.asarray(v) for k, v in pj.items()},
                              device="cpu")


def test_chain_hash_bytes_match_reference():
    assert tpc.ROOT_KEY == jpc.ROOT_KEY
    rs = np.random.RandomState(0)
    kt = kj = tpc.ROOT_KEY
    for n in (8, 8, 3, 16):
        chunk = rs.randint(0, 50000, n)
        kt, kj = tpc.chain_hash(kt, chunk), jpc.chain_hash(kj, chunk)
        assert kt == kj and len(kt) == 16
    # token ids hash as int32 whatever the input dtype
    assert tpc.chain_hash(tpc.ROOT_KEY, np.arange(4, dtype=np.int64)) == \
        jpc.chain_hash(jpc.ROOT_KEY, [0, 1, 2, 3])


def _index_script(pkg, capacity):
    """One script of index calls (mirroring the reference's index tests:
    refcount semantics, a diverging prompt, duplicate inserts, LRU
    leaf-first eviction of cache-only blocks, the capacity cap); every
    observable after every call."""
    alloc = pkg.BlockAllocator(16)
    idx = pkg.PrefixCacheIndex(alloc, block_size=4, capacity_blocks=capacity)
    obs = []

    def note(ret):
        obs.append((ret, [alloc.refcount(b) for b in range(16)],
                    alloc.num_shared, alloc.num_free, idx.num_blocks,
                    idx.num_reclaimable(), idx.stats()))

    toks = np.arange(11)                     # 2 full blocks + a tail
    owned = alloc.allocate(3)
    note(idx.insert(toks, owned))
    got, n = idx.acquire(toks)
    note((got, n))
    alloc.decref(got)
    note(idx.acquire(toks[:7]))
    alloc.decref(owned[:1])
    div = toks.copy()
    div[1] = 39
    note(idx.acquire(div))
    note(idx.peek(toks[:3]))
    alloc.free(owned)                        # cache-only now
    note(idx.peek(toks))
    dup = alloc.allocate(2)
    note(idx.insert(toks[:8], dup))          # never double-indexes
    alloc.free(dup)
    other = alloc.allocate(3)
    note(idx.insert(np.arange(20, 32), other))
    note(idx.acquire(np.arange(20, 32)))     # touch: toks' chain is LRU
    alloc.decref(other)
    note(idx.evict_blocks(3))                # leaves first, held ones kept
    alloc.free(other)
    note(idx.evict_blocks(10))
    more = alloc.allocate(4)
    note(idx.insert(np.arange(100, 116), more))
    alloc.free(more)
    note(idx.drop_all())
    return obs


@pytest.mark.parametrize("capacity", [0, 3])
def test_index_script_matches_reference(capacity):
    got = _index_script(tg, capacity)
    want = _index_script(jg, capacity)
    assert len(got) == len(want) == 13
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)


def _svc(params, **kw):
    gen = dict(GEN)
    gen.update(kw)
    return tg.GenerationService(params, tt.TransformerConfig(**DIMS),
                                tg.GenerationConfig(**gen), start=False,
                                device="cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_isolation_shared_blocks_never_mutated(params, kv_dtype):
    """A writer appending past a fully cached prompt gets a private
    copy-on-write block: the indexed blocks' bits (K, V and, for the int8
    pool, their scales) are unchanged, and a later sharer decodes
    identically."""
    svc = _svc(params, kv_dtype=kv_dtype)
    svc.start()
    prompt = np.random.RandomState(3).randint(0, DIMS["vocab"], 24)
    try:
        a = svc.generate(prompt, timeout=120)
        shared = sorted(e.block for e in svc._prefix._entries.values())
        assert shared, "a finished request leaves its full blocks resident"
        before = svc._cache.snapshot_blocks(shared)
        b = svc.generate(prompt, timeout=120)   # full hit: CoW, appends
        after = svc._cache.snapshot_blocks(shared)
        c = svc.generate(prompt, timeout=120)
        stats = svc.stats()
    finally:
        svc.stop()
    assert stats["counts"]["cow_copies"] >= 1
    assert stats["counts"]["prefix_hits"] >= 2
    assert set(before) == ({"k", "v"} if kv_dtype is None else
                           {"k", "v", "k_scale", "v_scale"})
    for key in before:
        np.testing.assert_array_equal(before[key], after[key])
    assert a == b == c
    assert svc._cache.allocator.num_used == 0   # stop() drops the index


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_hit_vs_miss_greedy_bit_identity(params, kv_dtype):
    """Greedy tokens are identical whether the prompt prefilled from
    scratch or reused shared blocks (a block-aligned prompt: full hit
    with its last position recomputed; a ragged one: suffix hit), with
    the scales copied along for the int8 pool."""
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, DIMS["vocab"], 24),
               rs.randint(0, DIMS["vocab"], 27)]

    def run(prefix_cache):
        svc = _svc(params, prefix_cache=prefix_cache, kv_dtype=kv_dtype)
        svc.start()
        try:
            outs = [[svc.generate(p, timeout=120) for p in prompts]
                    for _ in range(2)]
            return outs, svc.stats()
        finally:
            svc.stop()

    (first, second), st = run(True)
    (base, base2), st_off = run(False)
    assert first == second == base == base2
    assert st["prefix_cache"]["hits"] >= 2
    assert st["prefix_cache"]["cached_tokens"] >= 24 + 24
    assert st_off["prefix_cache"] is None
    assert st["counts"]["prefill_tokens"] < st_off["counts"]["prefill_tokens"]
