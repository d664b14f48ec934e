"""PyTorch port: the continuous-batching generation engine against the JAX
package's, plus the slice's guards.

Both packages' ``GenerationService`` run the same parameters and the same
config on the CPU; greedy and sampled tokens must be identical.  ``GEN``
is the reserve-ahead setting (``preemption=False, prefix_cache=False``);
``DEFAULTS`` keeps the reference's defaults (incremental allocation with
preemption, the prefix cache) on a pool small enough that preemption
fires, with prompts that share block-aligned prefixes, so the two engines
must also agree on preemptions, prefix hits, cached tokens, copy-on-write
copies and prefilled tokens; the int8 pool is served the same way.  A
prompt past the smallest rung is prefilled in chunks; a prompt past the
largest rung is refused by both at submit.
"""
import ast
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import observability as obs
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.serving import bucketing as jb
from mxnet_tpu.serving import generation as jg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import ServingClosedError
from mxnet_tpu_torch.serving import bucketing as tb
from mxnet_tpu_torch.serving import generation as tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
GEN = dict(max_slots=3, block_size=4, num_blocks=32, seq_buckets=[8, 16],
           max_new_tokens=6, preemption=False, prefix_cache=False)
# the reference's defaults for everything but sizes: 13 allocatable blocks
DEFAULTS = dict(max_slots=3, block_size=4, num_blocks=14, seq_buckets=[8, 16],
                max_new_tokens=6)


@pytest.fixture(autouse=True)
def _fresh_observability():
    """The JAX service's warmup/compile bookkeeping must not leak into
    later tests (same reset as tests/test_generation.py)."""
    yield
    obs.recompile.reset()


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    pj = jt.transformer_lm_init(jt.TransformerConfig(**DIMS),
                                jax.random.PRNGKey(1))
    pn = {k: np.asarray(v) for k, v in pj.items()}
    return pj, tt.params_from_jax(pn, device="cpu")


def _requests():
    rs = np.random.RandomState(5)
    lens = [5, 8, 13, 3, 11, 16, 7]
    reqs = []
    for i, n in enumerate(lens):
        prompt = rs.randint(0, DIMS["vocab"], size=n)
        if i % 2:
            kw = dict(temperature=0.8, top_k=[0, 10, 0][i % 3],
                      top_p=[1.0, 1.0, 0.9][i % 3], seed=100 + i)
        else:
            kw = {}
        reqs.append((prompt, kw))
    return reqs


def _serve(svc, reqs):
    try:
        streams = [svc.submit(p, **kw) for p, kw in reqs]
        svc.start()
        return [s.result(timeout=300) for s in streams]
    finally:
        svc.stop()


def test_services_emit_identical_tokens(params):
    pj, pt = params
    reqs = _requests()
    want = _serve(jg.GenerationService(pj, jt.TransformerConfig(**DIMS),
                                       jg.GenerationConfig(**GEN),
                                       start=False), reqs)
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(**GEN), start=False,
                               device="cpu")
    got = _serve(svc, reqs)
    assert got == want
    assert all(len(t) == GEN["max_new_tokens"] for t in got)
    st = svc.stats()
    assert st["counts"]["finished"] == len(reqs)
    assert st["counts"]["tokens"] == len(reqs) * GEN["max_new_tokens"]
    assert st["kv_blocks"]["used"] == 0 and st["decode_kernel"] == "paged"
    # the 13-token prompt ran as two chunks: 8 + 5 (padded to 8)
    assert svc._chunk_plan(13) == [(0, 8, 8, 2), (8, 5, 8, 4)]


def test_streaming_warmup_and_limits(params):
    _, pt = params
    cfg = tt.TransformerConfig(**DIMS)
    svc = tg.GenerationService(pt, cfg, tg.GenerationConfig(**GEN),
                               device="cpu")
    try:
        n = svc.warmup()
        assert n == svc.stats()["compiled_signatures"] > 0
        assert all((v["hits"], v["misses"]) == (0, 1)
                   for v in svc.compile_stats().values())
        assert set(svc.stats()["step_seconds"]) == {"gen_prefill",
                                                   "gen_decode"}
        seen = []
        stream = svc.submit([1, 2, 3], max_new_tokens=4,
                            on_token=lambda rid, t: seen.append(t))
        toks = list(stream)
        assert toks == seen and len(toks) == 4
        assert stream.finish_reason == "max_new_tokens"
        assert stream.ttft_ms is not None and stream.started
        # steady state runs only warmed signatures
        assert all(v["misses"] == 1 for v in svc.compile_stats().values())
        with pytest.raises(ValueError, match="exceeds the largest"):
            svc.submit(np.arange(17) % DIMS["vocab"])
        with pytest.raises(ValueError, match="max_len"):
            svc.submit([1] * 16, max_new_tokens=60)
        with pytest.raises(ValueError):
            svc.submit([DIMS["vocab"]])
    finally:
        svc.stop()
    with pytest.raises(ServingClosedError):
        svc.submit([1])


def test_bf16_service_serves(params):
    """amp_dtype="bfloat16": params and the KV pool in bf16 (the kernels'
    second dtype); the plain versions run the same dtype path on CPU."""
    _, pt = params
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(amp_dtype="bfloat16",
                                                   **GEN), device="cpu")
    try:
        assert svc.stats()["kv_dtype"] == "bfloat16"
        out = svc.generate([3, 1, 4, 1, 5, 9, 2, 6, 5], max_new_tokens=5,
                           temperature=0.7, seed=3, timeout=120)
        assert len(out) == 5 and all(0 <= t < DIMS["vocab"] for t in out)
    finally:
        svc.stop()


def test_long_prompt_refused_by_both(params):
    pj, pt = params
    jsvc = jg.GenerationService(pj, jt.TransformerConfig(**DIMS),
                                jg.GenerationConfig(**GEN), start=False)
    tsvc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                                tg.GenerationConfig(**GEN), start=False,
                                device="cpu")
    try:
        for svc in (jsvc, tsvc):
            with pytest.raises(ValueError, match="exceeds the largest"):
                svc.submit(np.ones(17, np.int64))
        # same prefill plans and warmup signature sets
        for n in range(1, 17):
            assert tsvc._chunk_plan(n) == jsvc._chunk_plan(n)
        assert tsvc._prefill_signatures() == jsvc._prefill_signatures()
    finally:
        jsvc.stop()
        tsvc.stop()


def test_block_allocator_parity():
    ja, ta = jg.BlockAllocator(9), tg.BlockAllocator(9)
    script = [("a", 3), ("a", 2), ("f", [2, 5]), ("a", 4), ("a", 2),
              ("f", [1]), ("a", 1), ("a", 5)]
    for op, arg in script:
        if op == "a":
            assert ta.allocate(arg) == ja.allocate(arg)
        else:
            ta.free(arg)
            ja.free(arg)
        assert (ta.num_free, ta.num_used, ta.occupancy()) == \
            (ja.num_free, ja.num_used, ja.occupancy())
    for blk in range(1, 9):
        assert ta.refcount(blk) == ja.refcount(blk)
    fresh = tg.BlockAllocator(4)
    got = fresh.allocate(2)
    fresh.free(got[:1])
    with pytest.raises(ValueError, match="double free"):
        fresh.free(got[:1])
    with pytest.raises(ValueError, match="out of range"):
        fresh.free([0])
    assert fresh.allocate(3) is None and fresh.num_free == 2
    assert tg.blocks_for(0, 4) == jg.blocks_for(0, 4) == 1
    assert [tg.blocks_for(n, 4) for n in range(1, 20)] == \
        [jg.blocks_for(n, 4) for n in range(1, 20)]


def test_paged_kv_cache_layout():
    c = tg.PagedKVCache(2, 4, 8, 16, 4, device="cpu")
    j = jg.PagedKVCache(2, 4, 8, 16, 4)
    assert c.shape == j.shape == (2, 16, 4, 4, 8)
    assert c.k.dtype == c.v.dtype == torch.float32
    assert c.allocator.num_free == j.allocator.num_free == 15


# -- scheduling (the port's engine on its own, on the CPU) ------------------------
SCHED = dict(max_slots=2, block_size=8, num_blocks=32, seq_buckets=[16, 32],
             max_new_tokens=8, preemption=False, prefix_cache=False)


def _greedy_oracle(pt, prompt, n_new):
    """Full-sequence greedy decoding with the port's forward — no cache."""
    cfg = tt.TransformerConfig(**DIMS)
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        logits = tt.transformer_lm_apply(pt, torch.tensor([toks]),
                                         torch.arange(len(toks)), cfg)
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def _svc(pt, **kw):
    gen = dict(SCHED)
    gen.update(kw)
    return tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                                tg.GenerationConfig(**gen), start=False,
                                device="cpu")


def test_continuous_batching_membership_and_greedy(params):
    """3 requests on 2 slots: the short one finishes and the queued one
    joins while the long one is still decoding; every token equals
    full-sequence greedy decoding."""
    _, pt = params
    svc = _svc(pt)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, DIMS["vocab"], n) for n in (11, 20, 5)]
    new = [8, 3, 6]
    try:
        hs = [svc.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        svc.start()
        results = [h.result(120) for h in hs]
    finally:
        svc.stop()
    for got, p, n in zip(results, prompts, new):
        assert got == _greedy_oracle(pt, p, n)
    member = [set(m) for _, m in svc.membership_history()]
    assert {0, 1} in member and {0, 2} in member
    i01, i02 = member.index({0, 1}), member.index({0, 2})
    assert i02 > i01 and all(0 in m for m in member[i01:i02 + 1])


def test_admission_waits_for_kv_blocks(params):
    """9 allocatable blocks of 8 positions; each request reserves
    blocks_for(20 + 12) = 4, so two fit and the third waits."""
    _, pt = params
    svc = _svc(pt, max_slots=3, num_blocks=10)
    rs = np.random.RandomState(3)
    try:
        hs = [svc.submit(rs.randint(0, DIMS["vocab"], 20), max_new_tokens=12)
              for _ in range(3)]
        svc.start()
        outs = [h.result(120) for h in hs]
    finally:
        svc.stop()
    assert all(len(o) == 12 for o in outs)
    member = [set(m) for _, m in svc.membership_history()]
    assert not any({0, 1, 2} <= m for m in member)
    assert any(2 in m for m in member)
    assert svc.stats()["kv_blocks"]["peak_occupancy"] == round(8 / 9, 4)


def test_backpressure_deadline_cancel_and_drain(params):
    _, pt = params
    svc = _svc(pt, queue_bound=2, backpressure="reject", max_slots=1)
    try:
        svc.submit(np.arange(4), max_new_tokens=2)
        svc.submit(np.arange(4), max_new_tokens=2)
        with pytest.raises(tg.engine.QueueFullError):
            svc.submit(np.arange(4), max_new_tokens=2)
        svc._waiting.clear()  # make room for the probes below
        expired = svc.submit(np.arange(4), max_new_tokens=2, deadline_ms=0.0)
        long = svc.submit(np.arange(8), max_new_tokens=30)
        svc.start()
        with pytest.raises(tg.engine.DeadlineExceededError):
            expired.result(60)
        queued = svc.submit(np.arange(8), max_new_tokens=4)
        queued.cancel()
        assert queued.result(60) == []
        assert queued.finish_reason == "cancelled"
        long.cancel()
        assert len(long.result(60)) <= 30
        assert long.finish_reason in ("cancelled", "max_new_tokens")
        backlog = [svc.submit(np.arange(5), max_new_tokens=3)
                   for _ in range(2)]
    finally:
        svc.stop(drain=True, timeout=120)
    assert all(h.finished and len(h.result(1)) == 3 for h in backlog)
    counts = svc.stats()["counts"]
    assert counts["rejected"] == 1 and counts["expired"] == 1
    assert counts["cancelled"] >= 1


def test_bucketing_parity():
    for n in (1, 5, 8, 100, 128, 1023):
        assert tb.seq_buckets(n) == jb.seq_buckets(n)
        assert tb.batch_buckets(n) == jb.batch_buckets(n)
        for m in (1, 7, 64, 2000):
            assert tb.bucket_batch(m, tb.batch_buckets(n)) == \
                jb.bucket_batch(m, jb.batch_buckets(n))
    for t in range(1, 33):
        assert tb.bucket_seq_len(t, [8, 16, 32]) == \
            jb.bucket_seq_len(t, [8, 16, 32])
    for bad in (0, 33):
        with pytest.raises(ValueError):
            tb.bucket_seq_len(bad, [8, 16, 32])
    np.testing.assert_array_equal(tb.pad_tokens_right([3, 4], 5),
                                  jb.pad_tokens_right([3, 4], 5))


def test_default_device_without_cuda_raises(params, monkeypatch):
    _, pt = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match='device="cpu"'):
        tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                             tg.GenerationConfig(**GEN), start=False)
    with pytest.raises(MXNetError, match='device="cpu"'):
        tt.params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(MXNetError, match='device="cpu"'):
        tt.transformer_lm_init(tt.TransformerConfig(**DIMS))


@pytest.mark.parametrize("kw", [
    dict(speculative=True), dict(multistep_k=4), dict(mp_devices=2),
    dict(amp_dtype="float16")])
def test_unported_config_raises(kw):
    base = dict(GEN)
    base.update(kw)
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=name):
        tg.GenerationConfig(**base)


@pytest.mark.parametrize("kw", [
    dict(preemption=True), dict(prefix_cache=True), dict(kv_dtype="int8")])
def test_reference_features_construct_and_serve(params, kw):
    """Configurations the port refused before this slice construct with
    the reference's values and serve a greedy request like the oracle."""
    _, pt = params
    base = dict(GEN)
    base.update(kw)
    cfg = tg.GenerationConfig(**base)
    assert getattr(cfg, next(iter(kw))) == next(iter(kw.values()))
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS), cfg,
                               device="cpu")
    prompt = np.arange(9) % DIMS["vocab"]
    try:
        out = svc.generate(prompt, max_new_tokens=5, timeout=120)
        st = svc.stats()
    finally:
        svc.stop()
    assert st["kv_dtype"] == (kw.get("kv_dtype") or "float32")
    assert st["preemption"] == cfg.preemption
    assert (st["prefix_cache"] is None) == (not cfg.prefix_cache)
    if kw.get("kv_dtype") is None:
        assert out == _greedy_oracle(pt, prompt, 5)
    else:
        assert len(out) == 5 and all(0 <= t < DIMS["vocab"] for t in out)


def test_config_validation_matches_reference(monkeypatch):
    for bad in (dict(kv_dtype="bogus"), dict(watermark_high=0.5,
                                             watermark_low=0.7),
                dict(watermark_low=0.0), dict(prefix_cache_blocks=-1),
                dict(multistep_k=0), dict(mp_devices=0)):
        for pkg in (tg, jg):
            with pytest.raises(ValueError):
                pkg.GenerationConfig(**bad)
    monkeypatch.setenv("TPUMX_GEN_WATERMARK_HIGH", "0.9")
    monkeypatch.setenv("TPUMX_GEN_PREFIX_CACHE_BLOCKS", "7")
    monkeypatch.setenv("TPUMX_GEN_KV_DTYPE", "int8")
    for pkg in (tg, jg):
        cfg = pkg.GenerationConfig()
        assert (cfg.watermark_high, cfg.prefix_cache_blocks,
                cfg.kv_dtype) == (0.9, 7, "int8")
    monkeypatch.setenv("TPUMX_GEN_KV_DTYPE", "off")
    assert tg.GenerationConfig().kv_dtype is None


def test_reference_defaults_not_silently_changed(params):
    """``tg.GenerationConfig()`` equals ``jg.GenerationConfig()`` on every
    field the port has, and a service built with no config serves them:
    incremental allocation with preemption and the prefix cache."""
    cfg, ref = tg.GenerationConfig(), jg.GenerationConfig()
    fields = sorted(vars(cfg))
    assert {"preemption", "prefix_cache", "watermark_high", "watermark_low",
            "prefix_cache_blocks", "kv_dtype"} <= set(fields)
    for k in fields:
        assert getattr(cfg, k) == getattr(ref, k), k
    assert cfg.preemption and cfg.prefix_cache and cfg.kv_dtype is None
    _, pt = params
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               device="cpu")
    try:
        assert svc._config.preemption and svc._prefix is not None
        assert svc._cache.allocator.watermark_high == cfg.watermark_high
        assert len(svc.generate([1, 2, 3], max_new_tokens=3,
                                timeout=120)) == 3
    finally:
        svc.stop()


def _waves():
    """Two waves over three 8-token (two-block) system prompts: wave 1 is
    each with a suffix plus one system prompt alone (block-aligned), wave
    2 five new suffixes and that block-aligned prompt once more (a full
    hit); odd requests sample."""
    rs = np.random.RandomState(5)
    system = [rs.randint(0, DIMS["vocab"], 8) for _ in range(3)]
    wave1 = [np.concatenate([system[i], rs.randint(0, DIMS["vocab"], n)])
             for i, n in enumerate([3, 4, 5])] + [system[0].copy()]
    wave2 = [np.concatenate([system[i % 3],
                             rs.randint(0, DIMS["vocab"], 2 + i)])
             for i in range(5)] + [system[0].copy()]

    def kw(i):
        return dict(temperature=0.8, top_k=10, seed=100 + i) if i % 2 else {}

    return [[(p, kw(i)) for i, p in enumerate(wave1)],
            [(p, kw(i + 10)) for i, p in enumerate(wave2)]]


def _serve_waves(svc, monkeypatch):
    """Serve each wave after the previous one has finished.  A wave
    arrives all at once: the engine loop admits nothing (its
    ``_admit_locked``, gated on the instance, returns no request) until
    every request of the wave is queued, so which requests share an
    admission does not depend on thread timing."""
    queued = threading.Event()
    admit = svc._admit_locked
    monkeypatch.setattr(svc, "_admit_locked",
                        lambda: admit() if queued.is_set() else [])
    try:
        svc.start()
        outs = []
        for wave in _waves():
            queued.clear()
            hs = [svc.submit(p, **kw) for p, kw in wave]
            queued.set()
            outs += [h.result(timeout=300) for h in hs]
        return outs, svc.stats()
    finally:
        svc.stop()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_services_with_reference_defaults_agree(params, kv_dtype,
                                                monkeypatch):
    """Preemption and the prefix cache on (the defaults), a 13-block pool,
    shared prefixes, each wave admitted once it is wholly queued:
    identical greedy and sampled tokens, and identical scheduling counts,
    each of them exercised."""
    pj, pt = params
    gen = dict(DEFAULTS, kv_dtype=kv_dtype)
    want, sj = _serve_waves(jg.GenerationService(
        pj, jt.TransformerConfig(**DIMS), jg.GenerationConfig(**gen),
        start=False), monkeypatch)
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(**gen), start=False,
                               device="cpu")
    got, st = _serve_waves(svc, monkeypatch)
    assert got == want
    assert all(len(t) == DEFAULTS["max_new_tokens"] for t in got)
    for key in ("preempted", "prefix_hits", "prefix_misses", "cached_tokens",
                "cow_copies", "prefill_tokens", "tokens", "finished"):
        assert st["counts"][key] == sj["counts"][key], key
        assert st["counts"][key] > 0, key
    assert st["kv_dtype"] == (kv_dtype or "float32")
    # finished requests left their blocks to the index; stop() released it
    assert st["kv_blocks"]["used"] == st["prefix_cache"]["blocks"] > 0
    assert svc._cache.allocator.num_used == 0


def test_default_plans_and_signatures_match_reference():
    """Under the defaults the chunk planner (fresh, re-prefill, cache-hit
    suffix) and the warmup signature set equal the reference's."""
    jsvc = jg.GenerationService({}, jt.TransformerConfig(**DIMS),
                                jg.GenerationConfig(**DEFAULTS), start=False)
    tsvc = tg.GenerationService({}, tt.TransformerConfig(**DIMS),
                                tg.GenerationConfig(**DEFAULTS), start=False,
                                device="cpu")
    try:
        for n in range(1, DIMS["max_len"]):
            assert tsvc._chunk_plan(n, force_chunked=True) == \
                jsvc._chunk_plan(n, force_chunked=True)
            for start in range(4, n, 4):
                assert tsvc._chunk_plan(n, start=start) == \
                    jsvc._chunk_plan(n, start=start)
        assert tsvc._prefill_signatures() == jsvc._prefill_signatures()
    finally:
        jsvc.stop()
        tsvc.stop()


def test_preempted_and_resumed_greedy_matches_oracle(params):
    """Two requests on a pool too small for both worst cases: incremental
    admission co-schedules them, growth preempts the newest, it resumes
    by re-prefilling its context — and every token equals full-sequence
    greedy decoding (as served unpressured)."""
    _, pt = params
    svc = _svc(pt, max_slots=2, num_blocks=8, preemption=True,
               prefix_cache=False)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, DIMS["vocab"], 20) for _ in range(2)]
    try:
        hs = [svc.submit(p, max_new_tokens=12) for p in prompts]
        svc.start()
        outs = [h.result(120) for h in hs]
        stats = svc.stats()
    finally:
        svc.stop()
    for p, got in zip(prompts, outs):
        assert got == _greedy_oracle(pt, p, 12)
    assert stats["counts"]["preempted"] >= 1
    assert {0, 1} in [set(m) for _, m in svc.membership_history()]
    assert hs[1]._req.n_preempted >= 1 and hs[0]._req.n_preempted == 0


def test_victim_is_newest_lowest_priority(params):
    _, pt = params
    svc = _svc(pt, max_slots=2, num_blocks=32, preemption=True,
               watermark_high=0.5, watermark_low=0.25)
    svc.submit(np.arange(9), max_new_tokens=4)
    svc.submit(np.arange(9), max_new_tokens=4)
    alloc = svc._cache.allocator
    with svc._lock:
        admitted = svc._admit_locked()
        assert len(admitted) == 2
        # incremental admission: blocks for prompt + 1 positions only
        assert len(admitted[0].blocks) == tg.blocks_for(10, 8)
        admitted[0].blocks.extend(alloc.allocate(8))
        admitted[1].blocks.extend(alloc.allocate(8))
        assert alloc.above_high()
        svc._watermark_preempt_locked()
        assert admitted[1].state == "waiting"
        assert admitted[0].state == "running"
        assert svc._waiting[0] is admitted[1]
    assert svc.stats()["counts"]["preempted"] == 1
    svc.stop(drain=False)

    vic = _svc(pt, max_slots=2, num_blocks=8, preemption=True)
    rs = np.random.RandomState(2)
    vic.submit(rs.randint(0, DIMS["vocab"], 20), max_new_tokens=12,
               priority=0)
    vic.submit(rs.randint(0, DIMS["vocab"], 20), max_new_tokens=12,
               priority=5)
    with vic._lock:
        admitted = vic._admit_locked()
        assert [r.priority for r in admitted] == [5, 0]
        # the low class is the victim though the high one is newer
        assert vic._slots[vic._pick_victim_locked()].priority == 0
    vic.stop(drain=False)


def test_allocator_watermarks_refcounts_and_cache_parity():
    ja, ta = jg.BlockAllocator(9, 0.75, 0.5), tg.BlockAllocator(9, 0.75, 0.5)
    script = [("a", 3), ("i", [1, 2]), ("d", [1]), ("a", 3), ("i", [4]),
              ("d", [1, 2, 3]), ("a", 2), ("w", (0.9, 0.6)), ("d", [4])]
    for op, arg in script:
        outs = []
        for al in (ta, ja):
            if op == "a":
                outs.append(al.allocate(arg))
            elif op == "i":
                outs.append(al.incref(arg))
            elif op == "d":
                outs.append(al.decref(arg))
            else:
                outs.append(al.set_watermarks(*arg))
        assert outs[0] == outs[1], op
        assert (ta.num_free, ta.num_shared, ta.above_high(), ta.above_low(),
                ta.can_allocate(3), ta.occupancy()) == \
            (ja.num_free, ja.num_shared, ja.above_high(), ja.above_low(),
             ja.can_allocate(3), ja.occupancy())
        assert [ta.refcount(b) for b in range(9)] == \
            [ja.refcount(b) for b in range(9)]
    for al in (ta, ja):
        with pytest.raises(ValueError, match="incref of unallocated"):
            al.incref([8])
        with pytest.raises(ValueError, match="watermarks"):
            al.set_watermarks(0.5, 0.6)
    import jax.numpy as jnp
    for shape in [(4, 8, 64, 16), (2, 4, 8, 8)]:
        for tdt, jdt in [(torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)]:
            for kv in (None, "int8"):
                assert tg.PagedKVCache.bytes_per_block(
                    *shape, dtype=tdt, kv_dtype=kv) == \
                    jg.PagedKVCache.bytes_per_block(*shape, dtype=jdt,
                                                    kv_dtype=kv)
                assert tg.PagedKVCache.num_blocks_for_bytes(
                    1 << 24, *shape, dtype=tdt, kv_dtype=kv) == \
                    jg.PagedKVCache.num_blocks_for_bytes(
                        1 << 24, *shape, dtype=jdt, kv_dtype=kv)
    c = tg.PagedKVCache(2, 4, 8, 16, 8, device="cpu", kv_dtype="int8")
    j = jg.PagedKVCache(2, 4, 8, 16, 8, kv_dtype="int8")
    assert c.quantized and c.k.dtype == torch.int8 and c.shape == j.shape
    assert tuple(c.k_scale.shape) == j.k_scale.shape == (2, 16, 4)
    assert (c.k_scale == 1).all() and c.nbytes() == j.nbytes()
    assert c.max_positions() == j.max_positions()
    f = tg.PagedKVCache(2, 4, 8, 16, 8, device="cpu")
    assert not f.quantized and f.k_scale is None and c.nbytes() < f.nbytes()
    with pytest.raises(ValueError, match="kv_dtype"):
        tg.PagedKVCache(2, 4, 8, 16, 8, device="cpu", kv_dtype="int4")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_reference():
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                              "chip_flash_sweep.py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving.generation,"
            " mxnet_tpu_torch.ops.flash_attention,"
            " mxnet_tpu_torch.ops.batch_norm,"
            " mxnet_tpu_torch.gluon.model_zoo.vision,"
            " mxnet_tpu_torch.parallel.data_parallel,"
            " mxnet_tpu_torch.parallel.compression,"
            " mxnet_tpu_torch.ops.twobit, mxnet_tpu_torch.gluon.loss;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
