"""PyTorch port: the generation engine's failure isolation and fault
injection, against the reference's contracts.

At the reference tests' tiny config: one injected step failure is
absorbed by the retry; a poisoned request (``TPUMX_FAULT_GEN_STEP_FAIL=
N@rid``) is isolated by bisection and quarantined with
``GenerationStepError`` at each step kind (single-token, speculative
verify, multi-step) while the others' greedy tokens equal the reference's
full-sequence oracle; a failing prefill consumes the error-requeue budget;
an iteration error outside the isolated decode requeues only untouched
requests; the flight recorder writes ``gen_quarantine`` and
``gen_requeue_budget`` dumps under ``tmp_path``; every ``TPUMX_FAULT_*``
spec parses (or is refused, naming the variable and token) as the
reference's injector does; shutdown, kill and the signal hooks.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.fault import inject as jinject
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.fault import PreemptionHandler, install_shutdown_hook
from mxnet_tpu_torch.fault.inject import injector
from mxnet_tpu_torch.observability import flight_recorder
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import DeadlineExceededError, ServingClosedError
from mxnet_tpu_torch.serving import generation as tg
from mxnet_tpu_torch.serving.generation import GenerationStepError

DIMS = dict(vocab=40, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
JCFG, TCFG = jt.TransformerConfig(**DIMS), tt.TransformerConfig(**DIMS)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMX_FLIGHT_RECORDER_DIR", str(tmp_path))
    yield
    monkeypatch.delenv("TPUMX_FAULT_GEN_STEP_FAIL", raising=False)
    injector().reset()
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
    """The reference's full-sequence greedy oracle (jitted apply)."""
    pj, _ = params
    apply = jax.jit(lambda p, t, pos: jt.transformer_lm_apply(p, t, pos,
                                                              JCFG))

    def run(prompt, n_new):
        toks = [int(t) for t in prompt]
        for _ in range(n_new):
            logits = apply(pj, jnp.asarray([toks], jnp.int32),
                           jnp.arange(len(toks), dtype=jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks[len(prompt):]

    return run


def _svc(pt, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("seq_buckets", [16, 32])
    kw.setdefault("max_new_tokens", 8)
    return tg.GenerationService(pt, TCFG, tg.GenerationConfig(**kw),
                                start=False, device="cpu")


def _dumps(tmp_path, reason):
    import json

    out = []
    for f in sorted(os.listdir(tmp_path)):
        if f.startswith("tpumx_flight_") and f"_{reason}_" in f:
            with open(os.path.join(tmp_path, f)) as fh:
                out.append(json.load(fh))
    return out


def test_transient_step_failure_retries_with_zero_blast_radius(
        params, oracle, monkeypatch):
    _, pt = params
    monkeypatch.setenv("TPUMX_FAULT_GEN_STEP_FAIL", "2")
    injector().reset()
    svc = _svc(pt, max_slots=3)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, DIMS["vocab"], n) for n in (5, 11, 17)]
    try:
        hs = [svc.submit(p, max_new_tokens=6) for p in prompts]
        svc.start()
        outs = [h.result(60) for h in hs]
        stats = svc.stats()
        retries = [h.stats()["retries"] for h in hs]
    finally:
        svc.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 6)
    c = stats["counts"]
    assert (c["step_failures"], c["quarantined"], c["failed"]) == (1, 0, 0)
    assert sum(retries) >= 1
    assert stats["consecutive_step_failures"] == 0


@pytest.mark.parametrize("mode", ["single", "spec", "multistep"])
def test_poisoned_request_quarantined_at_each_step_kind(
        params, oracle, monkeypatch, tmp_path, mode):
    """``N@rid`` fails every step holding rid 1 — single-token, verify or
    multi-step: bisection quarantines it alone; the others finish with
    the oracle's tokens; a gen_quarantine dump carries its wide event."""
    _, pt = params
    monkeypatch.setenv("TPUMX_FAULT_GEN_STEP_FAIL", "1@1")
    injector().reset()
    kw = {"single": {}, "spec": dict(speculative=True, draft_k=3),
          "multistep": dict(multistep_k=4)}[mode]
    svc = _svc(pt, max_slots=3, **kw)
    prompts = [np.array([1, 2, 3, 1, 2, 3, 1]), np.arange(13) % 7,
               np.array([5, 6, 5, 6, 5, 6, 5, 6, 5])]
    try:
        hs = [svc.submit(p, max_new_tokens=6) for p in prompts]
        svc.start()
        with pytest.raises(GenerationStepError, match="quarantined"):
            hs[1].result(60)
        out0, out2 = hs[0].result(60), hs[2].result(60)
        stats = svc.stats()
    finally:
        svc.stop()
    assert out0 == oracle(prompts[0], 6)
    assert out2 == oracle(prompts[2], 6)
    assert stats["counts"]["quarantined"] == 1
    assert stats["counts"]["step_failures"] >= 2
    assert hs[1].finish_reason == "error"
    dumps = _dumps(tmp_path, "gen_quarantine")
    assert len(dumps) == 1 and dumps[0]["extra"]["rid"] == 1
    assert dumps[0]["extra"]["request"]["outcome"] == "failed"


def test_prefill_error_requeues_then_fails_typed(params, monkeypatch,
                                                 tmp_path):
    _, pt = params
    svc = _svc(pt)
    orig = svc._programs.run

    def explode(kind, *a, **kw):
        if kind == "gen_prefill":
            raise RuntimeError("boom")
        return orig(kind, *a, **kw)

    monkeypatch.setattr(svc._programs, "run", explode)
    try:
        h = svc.submit(np.arange(5), max_new_tokens=2)
        svc.start()
        with pytest.raises(GenerationStepError, match="error requeues"):
            h.result(60)
        stats = svc.stats()
    finally:
        svc.stop()
    assert stats["counts"]["requeued"] == svc._max_error_requeues
    assert h.stats()["requeues"] == svc._max_error_requeues
    dumps = _dumps(tmp_path, "gen_requeue_budget")
    assert len(dumps) == 1 and dumps[0]["extra"]["rid"] == 0


def test_iteration_error_requeues_untouched_requests(params, oracle,
                                                     monkeypatch):
    """An error outside the isolated decode (here: the first decode
    dispatch itself) requeues the requests the iteration never advanced;
    they re-prefill and finish with the oracle's tokens."""
    _, pt = params
    svc = _svc(pt, max_slots=2)
    orig = svc._decode_isolated
    calls = {"n": 0}

    def flaky(running):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("surprise")
        return orig(running)

    monkeypatch.setattr(svc, "_decode_isolated", flaky)
    prompts = [np.arange(9) % 5, np.array([3, 9, 3, 9, 3])]
    try:
        hs = [svc.submit(p, max_new_tokens=5) for p in prompts]
        svc.start()
        outs = [h.result(60) for h in hs]
        stats = svc.stats()
    finally:
        svc.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 5)
    assert stats["counts"]["requeued"] >= 1
    assert stats["counts"]["failed"] == 0


@pytest.mark.parametrize("var,val,frag", [
    ("TPUMX_FAULT_KV_DROP", "push:x", "'x'"),
    ("TPUMX_FAULT_KV_DROP", "pushonly", "'pushonly'"),
    ("TPUMX_FAULT_KV_DROP", ":1", "':1'"),
    ("TPUMX_FAULT_KV_DROP", "push:", "'push:'"),
    ("TPUMX_FAULT_KV_DELAY_MS", "push:abc", "'abc'"),
    ("TPUMX_FAULT_KV_DELAY_MS", "push:10@", "'push:10@'"),
    ("TPUMX_FAULT_KV_KILL_SERVER", "soon", "'soon'"),
    ("TPUMX_FAULT_PREEMPT_AT_STEP", "n", "'n'"),
    ("TPUMX_FAULT_CKPT_CORRUPT", "melt", "'melt'"),
    ("TPUMX_FAULT_CKPT_CORRUPT", "flip@x", "'x'"),
    ("TPUMX_FAULT_GEN_STEP_FAIL", "x@1", "'x'"),
    ("TPUMX_FAULT_GEN_STEP_FAIL", "1@rid7", "'rid7'"),
    ("TPUMX_FAULT_GEN_KILL_REPLICA", "0@z", "'z'"),
])
def test_fault_spec_refused_like_reference(monkeypatch, var, val, frag):
    monkeypatch.setenv(var, val)
    for inj in (injector(), jinject.injector()):
        with pytest.raises(Exception) as ei:
            inj.reset()
        assert var in str(ei.value) and frag in str(ei.value)
    assert isinstance(ei.value, Exception)
    with pytest.raises(MXNetError):
        injector().reset()
    monkeypatch.delenv(var)
    jinject.injector().reset()


def test_fault_specs_parse_like_reference(monkeypatch):
    specs = {"TPUMX_FAULT_KV_DROP": "push:1,2;pull:3",
             "TPUMX_FAULT_KV_DELAY_MS": "push:200@1,2",
             "TPUMX_FAULT_KV_KILL_SERVER": "5",
             "TPUMX_FAULT_PREEMPT_AT_STEP": "7",
             "TPUMX_FAULT_CKPT_CORRUPT": "flip@2",
             "TPUMX_FAULT_GEN_STEP_FAIL": "4@2",
             "TPUMX_FAULT_GEN_KILL_REPLICA": "1@3"}
    for k, v in specs.items():
        monkeypatch.setenv(k, v)
    injector().reset()
    jinject.injector().reset()
    try:
        mine, ref = injector(), jinject.injector()
        for attr in ("_drops", "_delays", "_kill_after", "_preempt_step",
                     "_ckpt_mode", "_ckpt_at", "_gen_step_fail",
                     "_kill_replica"):
            assert getattr(mine, attr) == getattr(ref, attr), attr
        # occurrence counting: the kill fires exactly on replica 1's third
        # dispatch, the step failure on invocations >= 4 holding rid 2
        assert [mine.gen_kill_replica(1) for _ in range(4)] == \
            [False, False, True, False]
        assert [mine.gen_step_fail({2}) for _ in range(5)] == \
            [False, False, False, True, True]
        assert not mine.gen_step_fail({3})
    finally:
        for k in specs:
            monkeypatch.delenv(k)
        jinject.injector().reset()


def test_shutdown_finishes_slots_rejects_queue(params):
    _, pt = params
    svc = _svc(pt, max_slots=1, seq_buckets=[16], max_new_tokens=6,
               queue_bound=8)
    streams = [svc.submit([1, 2, 3], max_new_tokens=6) for _ in range(3)]
    svc.start()
    deadline = time.time() + 30
    while not any(r is not None for r in svc._slots):
        assert time.time() < deadline
        time.sleep(0.01)
    svc.shutdown(timeout=60)
    finished = rejected = 0
    for s in streams:
        try:
            assert len(s.result(timeout=30)) >= 1
            finished += 1
        except ServingClosedError:
            rejected += 1
    assert finished >= 1 and rejected >= 1 and finished + rejected == 3
    with pytest.raises(ServingClosedError):
        svc.submit([1, 2, 3])
    assert tobs.registry().counter(
        "serving_graceful_shutdowns_total").value >= 1


def test_kill_hangs_streams_and_reports_dead(params):
    _, pt = params
    svc = _svc(pt)
    h = svc.submit(np.arange(6), max_new_tokens=8)
    svc.kill()
    svc.start()   # a killed replica never restarts its loop
    health = svc.health()
    assert health["killed"] and not health["alive"]
    with pytest.raises(TimeoutError):
        h.result(0.2)
    assert svc.stats()["killed"] is True
    svc.stop(drain=False, timeout=5)


def test_stalled_worker_expiry(params, monkeypatch):
    _, pt = params
    svc = _svc(pt, max_slots=1)
    h = svc.submit(np.arange(4), max_new_tokens=2)
    with pytest.raises(TimeoutError, match="still running"):
        h.result(0.2)
    svc.stop(drain=False)
    with pytest.raises(ServingClosedError):
        h.result(1)
    svc = _svc(pt, max_slots=1)
    orig = svc._programs.run

    def slow(kind, *a, **kw):
        if kind == "gen_decode":
            time.sleep(0.05)
        return orig(kind, *a, **kw)

    monkeypatch.setattr(svc._programs, "run", slow)
    try:
        h_long = svc.submit(np.arange(8), max_new_tokens=20)
        h_queued = svc.submit(np.arange(8), max_new_tokens=4,
                              deadline_ms=200.0)
        svc.start()
        with pytest.raises(DeadlineExceededError, match="in queue"):
            h_queued.result(60)
        assert len(h_long.result(120)) == 20
        stats = svc.stats()
    finally:
        svc.stop()
    assert stats["counts"]["expired"] == 1


def test_signal_hooks_install_and_flight_recorder_refcount(params):
    _, pt = params
    svc = _svc(pt)
    try:
        assert svc.install_signal_handlers() is True
        assert svc.install_signal_handlers() is True   # idempotent
    finally:
        svc.stop(drain=False)
    assert svc._signal_unregister is None
    fired = []
    unreg = install_shutdown_hook(lambda s: fired.append(s))
    assert unreg is not None
    unreg()
    with PreemptionHandler() as ph:
        assert not ph.poll(0)
        ph.trigger()
        assert ph.triggered and ph.poll(1)
    flight_recorder.install()
    flight_recorder.install()
    flight_recorder.uninstall()
    assert flight_recorder._install_count >= 1
    flight_recorder.uninstall()


def test_flight_recorder_dump_and_gate(tmp_path, monkeypatch):
    flight_recorder.note("test", {"x": 1})
    path = flight_recorder.dump("unit", extra={"k": 2})
    assert path and os.path.dirname(path) == str(tmp_path)
    assert flight_recorder.last_dump() == path
    import json

    with open(path) as f:
        data = json.load(f)
    assert data["reason"] == "unit" and data["extra"] == {"k": 2}
    assert any(n["kind"] == "test" for n in data["notes"])
    assert set(data) >= {"spans", "wide_events", "metrics", "pid"}
    monkeypatch.setenv("TPUMX_FLIGHT_RECORDER", "0")
    assert flight_recorder.dump("off") is None
    monkeypatch.setenv("TPUMX_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("TPUMX_FLIGHT_RECORDER_DIR",
                       str(tmp_path / "missing" / "dir"))
    assert flight_recorder.dump("never_raises") is None
