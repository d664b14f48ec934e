"""PyTorch port: ``GenerationRouter`` over the port's replicas on the CPU.

At the reference tests' tiny config (``tests/test_router.py``): least-
loaded dispatch spreads requests and their greedy tokens equal the
reference's full-sequence oracle; ``TPUMX_FAULT_GEN_KILL_REPLICA`` kills a
replica holding queued work, which is resubmitted and finishes, while the
request already streaming there ends in ``ReplicaDeadError``; a sick
replica's breaker opens and closes again once it recovers; with every
replica broken a dispatch raises ``NoHealthyReplicaError``; a drain
shutdown finishes running requests and rejects queued ones; the signal
hub installs; shared-prefix affinity sends requests that share their
leading blocks to one replica (keyed by the port's ``chain_hash``); the
trace id survives a failover.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.fault.inject import injector
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import (GenerationConfig, GenerationRouter,
                                     GenerationService, NoHealthyReplicaError,
                                     ReplicaDeadError, RouterConfig,
                                     ServingClosedError)

DIMS = dict(vocab=40, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
JCFG, TCFG = jt.TransformerConfig(**DIMS), tt.TransformerConfig(**DIMS)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMX_FLIGHT_RECORDER_DIR", str(tmp_path))
    yield
    monkeypatch.delenv("TPUMX_FAULT_GEN_KILL_REPLICA", raising=False)
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


def _gc(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("seq_buckets", [16, 32])
    kw.setdefault("max_new_tokens", 8)
    return GenerationConfig(**kw)


def _router(pt, n=2, rc=None, start=True, **gc_kw):
    replicas = [GenerationService(pt, TCFG, _gc(**gc_kw), start=False,
                                  device="cpu") for _ in range(n)]
    return GenerationRouter(replicas=replicas,
                            config=rc or RouterConfig(
                                probe_interval_ms=10.0,
                                breaker_cooldown_ms=100.0),
                            start=start)


def test_least_loaded_spread_with_oracle_tokens(params, oracle):
    _, pt = params
    router = _router(pt, rc=RouterConfig(probe_interval_ms=10.0,
                                         affinity=False))
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 40, n) for n in (5, 11, 17, 7, 13, 9)]
    try:
        hs = [router.submit(p, max_new_tokens=4) for p in prompts]
        outs = [h.result(120) for h in hs]
        st = router.stats()
    finally:
        router.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 4)
    per = [r["dispatches"] for r in st["replicas"]]
    assert sum(per) == len(prompts) and all(d > 0 for d in per)
    assert st["healthy"] == 2


def test_router_builds_replicas_from_params(params, oracle):
    _, pt = params
    router = GenerationRouter(pt, TCFG, _gc(), RouterConfig(num_replicas=2),
                              device="cpu")
    try:
        assert router.warmup() > 0
        out = router.generate(np.arange(6), max_new_tokens=3, timeout=60)
        st = router.stats()
    finally:
        router.stop()
    assert out == oracle(np.arange(6), 3)
    assert [r["idx"] for r in st["replicas"]] == [0, 1]
    assert all(r.service._replica_id == r.idx for r in router._replicas)


def test_kill_resubmits_queued_work(params, oracle, monkeypatch):
    _, pt = params
    monkeypatch.setenv("TPUMX_FAULT_GEN_KILL_REPLICA", "0@2")
    injector().reset()
    router = _router(pt, max_slots=1)
    rs = np.random.RandomState(2)
    try:
        h_streaming = router.submit(rs.randint(0, 40, 8), max_new_tokens=50)
        deadline = time.perf_counter() + 60
        while not h_streaming.started and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert h_streaming.started
        prompts = [rs.randint(0, 40, 6) for _ in range(4)]
        hs = [router.submit(p, max_new_tokens=4) for p in prompts]
        outs = [h.result(120) for h in hs]
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            rep0 = router.stats()["replicas"][0]
            if rep0["dead"] and rep0["breaker"] == "open":
                break
            time.sleep(0.02)
        assert rep0["dead"] and rep0["breaker"] == "open"
        assert not rep0["health"]["alive"]
        assert sum(h.resubmits for h in hs) >= 1
        with pytest.raises(ReplicaDeadError):
            h_streaming.result(30)
        assert len(router.generate(rs.randint(0, 40, 5), max_new_tokens=3,
                                   timeout=60)) == 3
    finally:
        router.stop(drain=False, timeout=30)
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 4)


def test_breaker_reopens_after_recovery(params, monkeypatch):
    _, pt = params
    router = _router(pt, rc=RouterConfig(probe_interval_ms=10.0,
                                         breaker_failures=2,
                                         breaker_cooldown_ms=50.0))
    rep0 = router._replicas[0]
    orig = rep0.service.health
    sick = {"on": True}

    def flaky():
        h = orig()
        if sick["on"]:
            h["alive"] = False
        return h

    monkeypatch.setattr(rep0.service, "health", flaky)
    try:
        deadline = time.perf_counter() + 10
        while rep0.breaker == "closed" and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert rep0.breaker in ("open", "half_open")
        hs = [router.submit(np.arange(5), max_new_tokens=2)
              for _ in range(3)]
        [h.result(60) for h in hs]
        assert rep0.dispatches == 0
        sick["on"] = False
        deadline = time.perf_counter() + 10
        while rep0.breaker != "closed" and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert rep0.breaker == "closed"
        assert len(router.submit(np.arange(5),
                                 max_new_tokens=2).result(60)) == 2
    finally:
        router.stop()


def test_all_broken_raises_typed(params):
    _, pt = params
    router = _router(pt)
    try:
        for rep in router._replicas:
            rep.service.kill()
        deadline = time.perf_counter() + 10
        while router.stats()["healthy"] > 0 and \
                time.perf_counter() < deadline:
            time.sleep(0.02)
        with pytest.raises(NoHealthyReplicaError):
            router.submit(np.arange(4), max_new_tokens=2)
    finally:
        router.stop(drain=False, timeout=10)


def test_drain_shutdown_rejects_queued(params, monkeypatch):
    _, pt = params
    router = _router(pt, max_slots=1)
    for rep in router._replicas:
        orig = rep.service._programs.run

        def slow(kind, *a, _orig=orig, **kw):
            if kind == "gen_decode":
                time.sleep(0.01)
            return _orig(kind, *a, **kw)

        monkeypatch.setattr(rep.service._programs, "run", slow)
    rs = np.random.RandomState(3)
    running = [router.submit(rs.randint(0, 40, 6), max_new_tokens=20)
               for _ in range(2)]
    deadline = time.perf_counter() + 60
    while not all(h.started for h in running) and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    queued = [router.submit(rs.randint(0, 40, 6), max_new_tokens=20)
              for _ in range(3)]
    router.shutdown(timeout=120)
    for h in running:
        assert len(h.result(5)) == 20
    rejected = 0
    for h in queued:
        try:
            h.result(5)
        except ServingClosedError:
            rejected += 1
    assert rejected == len(queued)
    with pytest.raises(ServingClosedError):
        router.submit(np.arange(3))


def test_signal_handlers_install(params):
    _, pt = params
    router = _router(pt, n=1, start=False)
    try:
        assert router.install_signal_handlers() is True
    finally:
        router.uninstall_signal_handlers()
        router.stop(drain=False)
    assert router._signal_unregister is None


def test_shared_prefix_affinity(params, oracle):
    """Requests sharing their two leading blocks go to the replica that
    served the first of them, whose prefix cache then hits."""
    _, pt = params
    router = _router(pt, rc=RouterConfig(probe_interval_ms=10.0,
                                         affinity=True, affinity_blocks=2),
                     num_blocks=64)
    rs = np.random.RandomState(6)
    system = rs.randint(0, 40, 16)
    prompts = [np.concatenate([system, rs.randint(0, 40, 3)])
               for _ in range(4)]
    try:
        first = router.submit(prompts[0], max_new_tokens=3)
        out0 = first.result(60)
        hs = [router.submit(p, max_new_tokens=3) for p in prompts[1:]]
        outs = [out0] + [h.result(60) for h in hs]
        home = first.replica
        assert all(h.replica == home for h in hs)
        hits = router._replicas[home].service.stats()["prefix_cache"]["hits"]
        text = tobs.to_prometheus()
    finally:
        router.stop()
    assert hits >= 3
    assert "router_affinity_dispatches_total" in text
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 3)


def test_trace_id_survives_failover(params, monkeypatch):
    _, pt = params
    monkeypatch.setenv("TPUMX_FAULT_GEN_KILL_REPLICA", "0@1")
    injector().reset()
    router = _router(pt, max_slots=1)
    try:
        h = router.submit(np.arange(7), max_new_tokens=3)
        out = h.result(60)
        tid = h.trace_id
        st = h.stats()
    finally:
        router.stop(drain=False, timeout=30)
    assert len(out) == 3 and h.resubmits == 1 and h.replica == 1
    assert tid is not None and st["trace_id"] == tid
    names = [s["name"] for s in tobs.recent_spans(trace_id=tid)]
    assert "router.dispatch" in names and "router.resubmit" in names
    assert st["router_replica"] == 1 and st["resubmits"] == 1
