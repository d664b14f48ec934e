"""PyTorch port: the continuous-batching generation engine against the JAX
package's, plus the slice's guards.

Both packages' ``GenerationService`` run the same parameters and the same
explicit config (``preemption=False, prefix_cache=False`` — the JAX
defaults are True and the port's slice does not serve them) on the CPU;
greedy and sampled tokens must be identical.  A prompt past the smallest
rung is prefilled in chunks; a prompt past the largest rung is refused by
both at submit.
"""
import ast
import os
import subprocess
import sys

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
    dict(preemption=True), dict(prefix_cache=True), dict(speculative=True),
    dict(multistep_k=4), dict(kv_dtype="int8"), dict(mp_devices=2),
    dict(amp_dtype="float16")])
def test_unported_config_raises(kw):
    base = dict(GEN)
    base.update(kw)
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=name):
        tg.GenerationConfig(**base)


def test_reference_defaults_not_silently_changed():
    # the reference defaults preemption and prefix_cache to True: the port
    # refuses them instead of quietly serving something else
    with pytest.raises(NotImplementedError, match="preemption"):
        tg.GenerationConfig()
    cfg = tg.GenerationConfig(preemption=False, prefix_cache=False)
    ref = jg.GenerationConfig(preemption=False, prefix_cache=False)
    for k in ("max_slots", "block_size", "num_blocks", "max_new_tokens",
              "queue_bound", "backpressure", "chunked_prefill",
              "admission_budget", "multistep_k", "speculative"):
        assert getattr(cfg, k) == getattr(ref, k), k


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
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving.generation;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
