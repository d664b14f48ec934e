"""PyTorch port: speculative and multi-step decoding against the JAX
package.

At the reference tests' tiny config (``tests/test_speculative.py``): the
n-gram proposer, ``speculative_verify`` (target tokens bit for bit,
``accepted`` equal) and the draft model's proposals against the
reference's on the same inputs; then the port's services.  Greedy tokens
are held to the reference's full-sequence greedy oracle (``_greedy_oracle``
re-runs ``transformer_lm_apply`` per token) — not to the reference
service, whose draft-model and multi-step tests fail on the reference side
(its first multi-token step after an admission writes past the row's
block table).  Sampled tokens are held to the single-step services, the
port's and the reference's, bit for bit.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import observability as jobs
from mxnet_tpu.ops import sampling as jsmp
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.serving import generation as jg
from mxnet_tpu.serving.generation import speculative as jspec
from mxnet_tpu_torch import engine as teng
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import sampling as tsmp
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import generation as tg
from mxnet_tpu_torch.serving.generation import speculative as tspec

DIMS = dict(vocab=40, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
JCFG, TCFG = jt.TransformerConfig(**DIMS), tt.TransformerConfig(**DIMS)

# repetitive prompts so the n-gram proposer fires
REP = [np.array(([1, 2, 3, 4] * 5)[:17]), np.array([7, 8, 9] * 4),
       np.array([3, 1, 4, 1, 5, 9, 2, 6] * 3)]


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield
    jobs.recompile.reset()
    tobs.recompile.reset()


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    pj = jt.transformer_lm_init(JCFG, jax.random.PRNGKey(0))
    return pj, tt.params_from_jax({k: np.asarray(v) for k, v in pj.items()},
                                  device="cpu")


@pytest.fixture(scope="module")
def oracle(params):
    """The reference's full-sequence greedy oracle, memoized."""
    pj, _ = params
    apply = jax.jit(lambda p, t, pos: jt.transformer_lm_apply(p, t, pos,
                                                              JCFG))
    memo = {}

    def run(prompt, n_new):
        key = (tuple(int(t) for t in prompt), n_new)
        if key not in memo:
            toks = list(key[0])
            for _ in range(n_new):
                logits = apply(pj, jnp.asarray([toks], jnp.int32),
                               jnp.arange(len(toks), dtype=jnp.int32))
                toks.append(int(jnp.argmax(logits[0, -1])))
            memo[key] = toks[len(prompt):]
        return memo[key]

    return run


def _gc(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("seq_buckets", [16, 32])
    kw.setdefault("max_new_tokens", 8)
    return tg.GenerationConfig(**kw)


def _svc(pt, draft=False, **kw):
    extra = dict(draft_params=pt, draft_cfg=TCFG) if draft else {}
    return tg.GenerationService(pt, TCFG, _gc(**kw), start=False,
                                device="cpu", **extra)


# -- the n-gram proposer and the verify op -----------------------------------------
@pytest.mark.parametrize("toks,k,n", [
    ([5, 1, 2, 9, 1, 2], 3, 3), ([5, 1, 2, 9, 1, 2], 2, 3),
    ([1, 2, 7, 1, 2, 8, 1, 2], 2, 2), ([1, 2, 3, 4, 5], 4, 3),
    ([9, 1, 2, 1, 2], 4, 2), ([3], 4, 3), ([1, 2, 3], 0, 3),
    (list(REP[2]) + [3, 1], 4, 3)])
def test_propose_ngram_matches_reference(toks, k, n):
    assert tspec.propose_ngram(toks, k, n) == jspec.propose_ngram(toks, k, n)


def _verify_case(seed, B, T, V):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, V).astype(np.float32)
    seeds = rs.randint(0, 2 ** 31, B).astype(np.uint32)
    counters = rs.randint(0, 500, B).astype(np.uint32)
    temp = rs.choice([0.0, 0.7, 0.9], B).astype(np.float32)
    top_k = rs.choice([0, 5], B).astype(np.int32)
    top_p = rs.choice([1.0, 0.9], B).astype(np.float32)
    lengths = rs.randint(0, T + 1, B).astype(np.int32)
    return logits, seeds, counters, temp, top_k, top_p, lengths


@pytest.mark.parametrize("seed,B,T", [(11, 3, 4), (12, 5, 5), (13, 4, 2),
                                      (14, 2, 1)])
def test_speculative_verify_matches_reference(seed, B, T):
    """Drafts built from the reference's own targets (full, partial and
    no acceptance, garbage past ``lengths``): the port's target tokens
    equal the reference's bit for bit and ``accepted`` agrees."""
    V = 23
    logits, seeds, ctr, temp, tk, tp, lengths = _verify_case(seed, B, T, V)
    ref_t, _ = jsmp.speculative_verify(logits, np.zeros((B, T), np.int32),
                                       seeds, ctr, temp, tk, tp, lengths)
    ref_t = np.asarray(ref_t)
    fed = np.zeros((B, T), np.int32)
    rs = np.random.RandomState(seed + 100)
    for b in range(B):
        good = rs.randint(0, T)
        fed[b, 1:] = ref_t[b, :-1]
        if good + 1 < T:
            fed[b, good + 1] = (ref_t[b, good] + 1) % V
    want_t, want_a = jsmp.speculative_verify(logits, fed, seeds, ctr, temp,
                                             tk, tp, lengths)
    got_t, got_a = tsmp.speculative_verify(torch.from_numpy(logits),
                                           torch.from_numpy(fed), seeds,
                                           ctr, temp, tk, tp, lengths)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_sampler_takes_device_tensors():
    """Seeds and counters already on the logits' device (int64 tensors)
    give the same keys and tokens as numpy uint32 input."""
    logits, seeds, ctr, temp, tk, tp, _ = _verify_case(3, 4, 1, 31)
    lg = torch.from_numpy(logits[:, 0])
    want = tsmp.sample_logits(lg, seeds, ctr, temp, tk, tp)
    got = tsmp.sample_logits(lg, torch.from_numpy(seeds.astype(np.int64)),
                             torch.from_numpy(ctr.astype(np.int64)),
                             torch.from_numpy(temp), torch.from_numpy(
                                 tk.astype(np.int64)), torch.from_numpy(tp))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        tsmp.fold_keys(torch.from_numpy(seeds.astype(np.int64)),
                       torch.from_numpy(ctr.astype(np.int64))).numpy(),
        np.asarray(jsmp.fold_keys(seeds, ctr)).astype(np.int64))


# -- the draft model ----------------------------------------------------------------
def _window(toks, w):
    """The engine's draft window: the last min(len, w) tokens,
    right-aligned, with their global positions."""
    L = len(toks)
    n = min(L, w)
    window = np.zeros((1, w), np.int32)
    positions = np.zeros((1, w), np.int32)
    window[0, w - n:] = toks[L - n:]
    positions[0] = np.arange(L - w, L)
    return window, positions, np.array([n], np.int32)


@pytest.mark.parametrize("toks,w", [([4, 7, 1, 9, 2, 6], 16),
                                    (list(REP[0]), 8)])
def test_draft_model_matches_reference(params, oracle, toks, w):
    """The draft's proposals equal the reference's on the same window
    (right-aligned, padded, clipped); with the window covering the whole
    context they are the greedy oracle's, and the first step's logits
    agree with the full forward's to rtol 1e-4."""
    pj, pt = params
    window, positions, n_valid = _window(toks, w)
    want = jspec.DraftModel(pj, JCFG, k=4, window=w).propose(
        window, positions, n_valid)
    draft = tspec.DraftModel(pt, TCFG, k=4, window=w, device="cpu")
    got = draft.propose(window, positions, n_valid)
    np.testing.assert_array_equal(got, np.asarray(want))
    st = draft.compile_stats()
    assert len(st) == 1 and next(iter(st))[0] == "gen_draft"
    if len(toks) <= w:
        assert list(got[0]) == oracle(toks, 4)
        logits = tspec._draft_logits(
            pt, torch.from_numpy(window.astype(np.int64)),
            torch.from_numpy(positions.astype(np.int64)),
            torch.from_numpy(n_valid.astype(np.int64)), TCFG)
        full = jt.transformer_lm_apply(
            pj, jnp.asarray([toks], jnp.int32),
            jnp.arange(len(toks), dtype=jnp.int32), JCFG)[0, -1]
        np.testing.assert_allclose(logits[0].numpy(), np.asarray(full),
                                   rtol=1e-4, atol=1e-5)


def test_draft_model_validation(params):
    _, pt = params
    with pytest.raises(ValueError, match="window"):
        tspec.DraftModel(pt, TCFG, k=2, window=TCFG.max_len + 1,
                         device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        _svc(pt, speculative=True, draft_mode="model")
    bad = tt.TransformerConfig(vocab=41, d_model=16, n_heads=2, n_layers=1,
                               d_ff=32, max_len=64)
    with pytest.raises(ValueError, match="vocab"):
        tg.GenerationService(
            pt, TCFG, _gc(speculative=True, draft_mode="model"),
            start=False, device="cpu",
            draft_params=tt.transformer_lm_init(bad, device="cpu"),
            draft_cfg=bad)
    with pytest.raises(ValueError, match="draft_mode"):
        _gc(speculative=True, draft_mode="oracle")


# -- speculative decode ---------------------------------------------------------------
def test_spec_greedy_matches_oracle_across_membership(params, oracle):
    """Staggered arrivals, mixed lengths, the n-gram proposer on: every
    request's greedy tokens equal the oracle as the verify batch's
    membership changes."""
    _, pt = params
    prompts = REP + [np.array([11, 5, 11, 5, 11, 5, 2])]
    svc = _svc(pt, max_slots=3, speculative=True, draft_k=4)
    try:
        svc.warmup()
        svc.start()
        hs = []
        for i, p in enumerate(prompts):
            hs.append(svc.submit(p, max_new_tokens=6 + (i % 4)))
            if i % 2 == 0:
                time.sleep(0.01)
        outs = [h.result(180) for h in hs]
        req = [h.stats() for h in hs]
        stats = svc.stats()
    finally:
        svc.stop()
    for i, p in enumerate(prompts):
        assert outs[i] == oracle(p, 6 + (i % 4)), i
    assert stats["decode_mode"] == "spec"
    assert stats["speculative"]["spec_steps"] >= 1
    assert stats["speculative"]["proposed_tokens"] >= 1
    assert any(r["decode_mode"] == "spec" for r in req)
    for r in req:
        if r["draft_proposed_tokens"]:
            assert r["accepted_ratio"] == pytest.approx(
                r["draft_accepted_tokens"] / r["draft_proposed_tokens"],
                abs=1e-3)


def test_spec_draft_model_full_acceptance(params, oracle):
    """The target as its own draft, window covering the context: every
    proposal is accepted and the tokens are the oracle's."""
    _, pt = params
    svc = _svc(pt, draft=True, speculative=True, draft_mode="model",
               draft_k=3, draft_window=32)
    prompts = [np.array([4, 7, 1, 9, 2, 6]), np.array([12, 3, 12, 3, 5])]
    try:
        svc.warmup()
        svc.start()
        outs = [svc.generate(p, max_new_tokens=8, timeout=180)
                for p in prompts]
        stats = svc.stats()
    finally:
        svc.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 8)
    spec = stats["speculative"]
    assert spec["draft_mode"] == "model" and spec["proposed_tokens"] >= 1
    assert spec["accepted_ratio"] == 1.0


def _sampled(svc, prompts):
    try:
        svc.start()
        return [svc.generate(p, max_new_tokens=8, temperature=0.9,
                             top_k=10, top_p=0.95, seed=100 + i,
                             timeout=180)
                for i, p in enumerate(prompts)], svc.stats()
    finally:
        svc.stop()


@pytest.fixture(scope="module")
def single_step_sampled(params):
    """The sampled requests through the single-step services, the port's
    and the reference's (once for the module)."""
    pj, pt = params
    base, _ = _sampled(_svc(pt), REP)
    jcfg = jg.GenerationConfig(max_slots=2, block_size=8, num_blocks=32,
                               seq_buckets=[16, 32], max_new_tokens=8)
    ref, _ = _sampled(jg.GenerationService(pj, JCFG, jcfg, start=False),
                      REP)
    jobs.recompile.reset()
    return base, ref


@pytest.mark.parametrize("mode", ["ngram", "model", "multistep"])
def test_sampled_tokens_equal_single_step(params, single_step_sampled,
                                          mode):
    """Sampled requests draw the same tokens as the single-step services,
    the port's and the reference's: sampling is keyed on (seed,
    position)."""
    _, pt = params
    kw = {"ngram": dict(speculative=True, draft_k=4),
          "model": dict(speculative=True, draft_mode="model", draft_k=3,
                        draft_window=32),
          "multistep": dict(multistep_k=4, max_slots=1)}[mode]
    got, st = _sampled(_svc(pt, draft=mode == "model", **kw), REP)
    base, ref = single_step_sampled
    assert got == base == ref
    if mode == "multistep":
        assert st["multistep"]["steps"] >= 1
    else:
        assert st["speculative"]["spec_steps"] >= 1


def test_preemption_mid_speculation(params, oracle):
    """Nine allocatable blocks: both requests are admitted (each secures
    its context plus one verify span, 4 blocks), then block growth past
    the watermark preempts one while speculation runs; it resumes by
    re-prefill and both match the oracle."""
    _, pt = params
    svc = _svc(pt, max_slots=2, num_blocks=10, preemption=True,
               speculative=True, draft_k=4)
    prompts = [np.tile([1, 2, 3, 4, 5], 4), np.tile([7, 8, 9, 2], 5)]
    try:
        hs = [svc.submit(p, max_new_tokens=20) for p in prompts]
        svc.start()
        outs = [h.result(180) for h in hs]
        stats = svc.stats()
    finally:
        svc.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 20)
    assert stats["counts"]["preempted"] >= 1, stats["counts"]
    assert stats["speculative"]["spec_steps"] >= 1


def test_int8_shared_blocks_untouched_by_rejecting_verify(params):
    """int8 pool + prefix cache + speculation: the indexed blocks' bits
    (payload and scales) are unchanged after a speculating sharer ran, and
    every sharer decodes the same tokens."""
    _, pt = params
    svc = _svc(pt, kv_dtype="int8", prefix_cache=True, speculative=True,
               draft_k=4, num_blocks=64)
    prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6] * 3)   # 3 full blocks
    try:
        svc.start()
        a = svc.generate(prompt, timeout=180)
        shared = sorted(e.block for e in svc._prefix._entries.values())
        assert shared
        before = svc._cache.snapshot_blocks(shared)
        assert set(before) == {"k", "v", "k_scale", "v_scale"}
        b = svc.generate(prompt, timeout=180)
        after = svc._cache.snapshot_blocks(shared)
        c = svc.generate(prompt, timeout=180)
        stats = svc.stats()
    finally:
        svc.stop()
    for name in before:
        np.testing.assert_array_equal(before[name], after[name])
    assert a == b == c
    assert stats["speculative"]["spec_steps"] >= 1
    assert stats["prefix_cache"]["hits"] >= 2


def test_int8_ngram_tokens_equal_reference(params):
    """n-gram speculation on the int8 pool, one slot: the port's tokens and
    its proposed and accepted counts equal the reference service's on the
    same requests, each prompt greedy and then sampled.  Drafts are
    rejected on both sides, so the verify writes, the boundary blocks
    requantized under scales that saw the rejected drafts, and the T=5
    verify over the int8 pool are held to the reference's."""
    pj, pt = params
    prompts = REP + [np.array([5, 6, 5, 6, 5, 6, 9, 9, 5])]
    asks = [(p, {}) for p in prompts] + [
        (p, dict(temperature=0.9, top_k=10, top_p=0.95, seed=100 + i))
        for i, p in enumerate(prompts)]
    gen = dict(max_slots=1, block_size=8, num_blocks=32, seq_buckets=[16, 32],
               max_new_tokens=8, kv_dtype="int8", speculative=True,
               draft_k=4)

    def run(svc):
        try:
            svc.start()
            outs = [svc.generate(p, timeout=180, **kw) for p, kw in asks]
            return outs, svc.stats()["speculative"]
        finally:
            svc.stop()

    got, st = run(tg.GenerationService(pt, TCFG, tg.GenerationConfig(**gen),
                                       start=False, device="cpu"))
    want, sj = run(jg.GenerationService(pj, JCFG, jg.GenerationConfig(**gen),
                                        start=False))
    assert got == want
    for key in ("proposed_tokens", "accepted_tokens", "spec_steps"):
        assert st[key] == sj[key], key
    assert 0 < st["accepted_tokens"] < st["proposed_tokens"]


def test_int8_partial_rejection_caps_index_safe_len(params):
    """A partial rejection on the int8 pool with the context ending inside
    a block caps ``index_safe_len`` at the block boundary."""
    _, pt = params
    svc = _svc(pt, kv_dtype="int8", speculative=True, draft_k=4,
               num_blocks=64)
    try:
        svc.start()
        h = svc.submit(np.array([5, 6, 5, 6, 5, 6, 9, 9, 5]),
                       max_new_tokens=8)
        h.result(180)
        r = h._req
        stats = svc.stats()
    finally:
        svc.stop()
    spec = stats["speculative"]
    if spec["proposed_tokens"] > spec["accepted_tokens"]:
        assert r.index_safe_len is not None
        assert r.index_safe_len % 8 == 0


# -- multi-step decode ----------------------------------------------------------------
def test_multistep_greedy_matches_oracle(params, oracle):
    _, pt = params
    svc = _svc(pt, multistep_k=4)
    try:
        svc.warmup()
        svc.start()
        outs = [svc.generate(p, max_new_tokens=8, timeout=180)
                for p in (np.array([4, 7, 1, 9, 2, 6]), np.array([12, 3, 5]))]
        stats = svc.stats()
    finally:
        svc.stop()
    assert outs[0] == oracle(np.array([4, 7, 1, 9, 2, 6]), 8)
    assert outs[1] == oracle(np.array([12, 3, 5]), 8)
    assert stats["multistep"]["steps"] >= 1
    assert stats["decode_mode"] == "multistep"


def test_multistep_int8_equals_single_step(params):
    _, pt = params

    def run(k):
        svc = _svc(pt, kv_dtype="int8", multistep_k=k)
        try:
            svc.start()
            return [svc.generate(p, max_new_tokens=8, temperature=0.7,
                                 seed=i, timeout=180)
                    for i, p in enumerate(REP)]
        finally:
            svc.stop()

    assert run(4) == run(1)


def test_multistep_policy_bulk_and_queue_pressure(params):
    """Queue pressure forces k=1; an ``engine.bulk`` scope overrides it
    with min(config k, bulk size) floored onto the pow2 ladder; with no
    waiters the configured k is bounded by the remaining budget."""
    _, pt = params
    svc = _svc(pt, max_slots=1, multistep_k=4)
    try:
        svc.submit(np.arange(6), max_new_tokens=8)
        svc.submit(np.arange(5), max_new_tokens=8)
        with svc._lock:
            batch = svc._admit_locked()
        assert len(batch) == 1 and len(svc._waiting) == 1
        assert svc._choose_multistep_k(batch) == 1
        with teng.bulk(2):
            assert svc._choose_multistep_k(batch) == 2
        with teng.bulk(64):
            assert svc._choose_multistep_k(batch) == 4
        with teng.bulk(3):
            assert svc._choose_multistep_k(batch) == 2
        assert teng.fusion_hint() == 1
    finally:
        svc.stop(drain=False)
    svc2 = _svc(pt, max_slots=2, multistep_k=8)
    try:
        svc2.submit(np.arange(6), max_new_tokens=3)
        with svc2._lock:
            batch2 = svc2._admit_locked()
        assert svc2._choose_multistep_k(batch2) == 2
    finally:
        svc2.stop(drain=False)


# -- warm-up covers every key ---------------------------------------------------------
def test_no_new_key_after_warmup_under_freeze(params, monkeypatch):
    """Warmup enumerates the verify (Tk, W) ladder and every multi-step
    (k, W) key; a mixed workload then runs frozen with one miss per key."""
    _, pt = params
    svc = _svc(pt, max_slots=3, speculative=True, draft_k=4, multistep_k=4)
    try:
        warmed = svc.warmup()
        assert warmed == len(svc.compile_stats())
        kinds = {k[0] for k in svc.compile_stats()}
        assert {"gen_verify", "gen_multistep"} <= kinds
        monkeypatch.setenv("TPUMX_FREEZE_COMPILES", "1")
        svc.start()
        rs = np.random.RandomState(5)
        hs = []
        for i in range(6):
            p = REP[i % 3] if i % 2 == 0 \
                else rs.randint(0, DIMS["vocab"], 5 + 3 * i)
            hs.append(svc.submit(p, max_new_tokens=4 + (i % 4),
                                 temperature=0.5 * (i % 2), seed=i))
        for h in hs:
            h.result(180)
        stats = svc.compile_stats()
        counts = svc.stats()["counts"]
    finally:
        svc.stop()
    assert counts["failed"] == 0
    for key, st in stats.items():
        assert st["misses"] == 1, key


def test_draft_model_no_new_key_after_warmup(params, monkeypatch):
    _, pt = params
    svc = _svc(pt, draft=True, speculative=True, draft_mode="model",
               draft_k=3, draft_window=32)
    try:
        svc.warmup()
        monkeypatch.setenv("TPUMX_FREEZE_COMPILES", "1")
        svc.start()
        outs = [svc.generate(p, max_new_tokens=6, timeout=180)
                for p in (np.array([4, 7, 1, 9, 2, 6]), np.array([12, 3, 5]))]
        stats = list(svc.compile_stats().items()) \
            + list(svc._draft.compile_stats().items())
    finally:
        svc.stop()
    assert all(outs)
    for key, st in stats:
        assert st["misses"] == 1, key


def test_features_off_run_the_single_step(params, oracle):
    _, pt = params
    svc = _svc(pt)
    assert svc._verify_buckets == [] and svc._ms_buckets == []
    assert svc._iter_span == 1 and svc._draft is None
    try:
        svc.warmup()
        assert {k[0] for k in svc.compile_stats()}.isdisjoint(
            {"gen_verify", "gen_multistep", "gen_draft"})
        svc.start()
        outs = [svc.generate(p, max_new_tokens=6, timeout=180) for p in REP]
        stats = svc.stats()
    finally:
        svc.stop()
    for p, got in zip(REP, outs):
        assert got == oracle(p, 6)
    assert stats["decode_mode"] == "single" and stats["speculative"] is None
    assert stats["multistep"]["steps"] == 0


def test_env_gates_parse_like_reference(monkeypatch):
    for k, v in (("TPUMX_GEN_SPECULATIVE", "1"),
                 ("TPUMX_GEN_DRAFT_MODE", "model"),
                 ("TPUMX_GEN_DRAFT_K", "6"), ("TPUMX_GEN_DRAFT_NGRAM", "2"),
                 ("TPUMX_GEN_DRAFT_WINDOW", "24"),
                 ("TPUMX_GEN_MULTISTEP_K", "8")):
        monkeypatch.setenv(k, v)
    got, want = _gc(), jg.GenerationConfig(max_slots=2)
    for name in ("speculative", "draft_mode", "draft_k", "draft_ngram",
                 "draft_window", "multistep_k"):
        assert getattr(got, name) == getattr(want, name), name
    for bad in (dict(draft_k=0), dict(draft_ngram=0), dict(draft_window=0),
                dict(multistep_k=0), dict(draft_mode="x")):
        for pkg in (tg, jg):
            with pytest.raises(ValueError):
                pkg.GenerationConfig(**bad)
    # under model parallelism the modes construct, as the reference's do
    got = _gc(mp_devices=2, speculative=True, multistep_k=4)
    want = jg.GenerationConfig(max_slots=2, mp_devices=2, speculative=True,
                               multistep_k=4)
    for name in ("mp_devices", "speculative", "multistep_k"):
        assert getattr(got, name) == getattr(want, name), name


def test_engine_facade():
    assert teng.fusion_hint() == 1
    old = teng.bulk_size()
    with teng.bulk(5):
        assert teng.fusion_hint() == 5 and teng.bulk_size() == 5
    assert teng.bulk_size() == old and teng.fusion_hint() == 1
    assert not teng.is_naive()
    with teng.NaiveEngine():
        assert teng.is_naive()
        assert teng.current_engine_type() == "NaiveEngine"
    teng.wait_all()
    for name in ("push", "new_var", "wait_for_var", "host_engine"):
        with pytest.raises(MXNetError, match=name):
            getattr(teng, name)()
