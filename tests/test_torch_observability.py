"""PyTorch port: the observability subsystem and the generation engine's
telemetry against the JAX package's.

The metrics registry's snapshot and Prometheus text equal the reference
registry's after the same operations; spans land in the profiler stream;
the recompile explainer and freeze watchdog behave as the reference's.
Both packages' ``GenerationService`` serve the same request set (tiny
config, all requests queued before the loop starts, so the schedule is
fixed): every wide-event key, the deterministic wide-event values, the
``stats()`` keys (the port adds ``step_seconds`` and ``device``) and the
counts are equal.  Then the port alone: trace contexts and spans of one
request, the TTFT breakdown, the JSONL sink, the generation gauges in the
Prometheus text, ``health()`` and ``load()``.  Train telemetry: the
gauges ``Module.fit`` publishes equal the reference's, ``TPUMX_TELEMETRY=0``
leaves the parameters bitwise unchanged, and the counters add up over fp16
overflow steps (its dp=2 leg: ``tests/test_torch_module_parallel.py``).
"""
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import observability as jobs
from mxnet_tpu.observability.metrics import MetricsRegistry as JRegistry
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.serving import generation as jg
from mxnet_tpu.serving import metrics as jsm
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.observability import exposition, recompile, tracing
from mxnet_tpu_torch.observability.metrics import MetricsRegistry
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import generation as tg
from mxnet_tpu_torch.serving import metrics as tsm

DIMS = dict(vocab=40, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
GEN = dict(max_slots=2, block_size=8, num_blocks=32, seq_buckets=[16, 32],
           max_new_tokens=5)
# wide-event fields that depend on the schedule and the tokens, not on time
DETERMINISTIC = ("request_id", "priority", "prompt_tokens", "output_tokens",
                 "outcome", "finish_reason", "error", "decode_steps",
                 "preemptions", "requeues", "retries", "prefix_cached_tokens",
                 "cow_copies", "decode_mode", "accepted_ratio",
                 "draft_proposed_tokens", "draft_accepted_tokens", "replica")


@pytest.fixture(autouse=True)
def _fresh():
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
    pj = jt.transformer_lm_init(jt.TransformerConfig(**DIMS),
                                jax.random.PRNGKey(0))
    return pj, tt.params_from_jax({k: np.asarray(v) for k, v in pj.items()},
                                  device="cpu")


def _exercise(reg):
    reg.counter("requests_total", labels={"svc": 'a"b'},
                help="total requests").inc(3)
    reg.counter("requests_total", labels={"svc": "c"}).inc()
    g = reg.gauge("queue_depth", help="depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("ttft_seconds").observe(0.02)
    return reg


def test_registry_snapshot_and_prometheus_equal_reference():
    mine, ref = _exercise(MetricsRegistry()), _exercise(JRegistry())
    assert mine.to_prometheus() == ref.to_prometheus()
    assert mine.snapshot() == ref.snapshot()
    json.dumps(mine.snapshot())


def test_registry_semantics_and_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter("req_total", labels={"svc": "a"})
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("req_total", labels={"svc": "a"}) is c
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    hot = reg.counter("hot_total")

    def worker():
        for _ in range(500):
            hot.inc()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert hot.value == 2000


def test_dump_prometheus_and_http_endpoint(tmp_path):
    reg = MetricsRegistry()
    reg.counter("written_total").inc(9)
    path = str(tmp_path / "metrics.prom")
    reg.dump_prometheus(path)
    assert "written_total 9" in open(path).read()
    with exposition.start_http_server(port=0, registry=reg) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
        assert b"written_total 9" in body
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/snapshot", timeout=5).read())
        assert snap["counters"]["written_total"] == 9


def test_spans_emit_into_profiler_stream():
    profiler.set_state("run")
    try:
        with tracing.span("outer", cat="t"):
            with tracing.span("inner", cat="t"):
                assert tracing.span_stack() == ["outer", "inner"]
    finally:
        profiler.set_state("stop")
    with tracing.span("stopped", cat="t"):
        pass
    events = json.loads(profiler.dumps(format="json",
                                       reset=True))["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert "outer" in spans and "inner" in spans and "stopped" not in spans
    assert spans["inner"]["args"]["parent"] == "outer"


def test_profiler_counter_domain_and_scope():
    dom = profiler.Domain("d")
    c = profiler.Counter(dom, "n")

    def bump():
        for _ in range(500):
            c.increment()

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c._value == 2000
    profiler.set_state("run")
    with profiler.scope("region"):
        pass
    profiler.set_state("stop")
    assert "region" in profiler.dumps(reset=True)


def test_recompile_explainer_and_freeze(monkeypatch):
    site = ("gen_decode_paged", ("lm",))
    k1 = ("gen_decode", (("tokens", (4, 1), "int32"),))
    k2 = ("gen_decode", (("tokens", (8, 1), "int32"),))
    recompile.note_cache(False, site, k1)
    recompile.note_cache(True, site, k1)
    recompile.note_cache(False, site, k2)
    want = jobs.recompile.explain_key_diff(k1, k2)
    assert recompile.explain_key_diff(k1, k2) == want
    assert recompile.last_explanations(1)[0]["causes"] == want
    tobs.mark_warm()
    monkeypatch.setenv("TPUMX_FREEZE_COMPILES", "1")
    with pytest.raises(recompile.FreezeCompilesError, match="post-warmup"):
        recompile.note_cache(False, site, ("gen_decode", ()))
    recompile.note_cache(True, site, k1)   # hits never raise


def _serve(svc, prompts, kws):
    try:
        hs = [svc.submit(p, **kw) for p, kw in zip(prompts, kws)]
        svc.start()
        outs = [h.result(120) for h in hs]
        return outs, [h.stats() for h in hs], svc.stats()
    finally:
        svc.stop()


@pytest.mark.parametrize("extra", [{}, dict(speculative=True, draft_k=3)],
                         ids=["single", "spec"])
def test_wide_event_and_stats_keys_equal_reference(params, extra):
    pj, pt = params
    rs = np.random.RandomState(7)
    prompts = [np.array([1, 2, 3, 1, 2, 3]), rs.randint(0, 40, 11),
               rs.randint(0, 40, 4)]
    kws = [{}, dict(temperature=0.8, top_k=10, seed=3), {}]
    ref = _serve(jg.GenerationService(
        pj, jt.TransformerConfig(**DIMS),
        jg.GenerationConfig(**GEN, **extra), start=False), prompts, kws)
    got = _serve(tg.GenerationService(
        pt, tt.TransformerConfig(**DIMS),
        tg.GenerationConfig(**GEN, **extra), start=False, device="cpu"),
        prompts, kws)
    assert got[0] == ref[0]
    for w, g in zip(ref[1], got[1]):
        assert set(g) == set(w)
        assert {k: g[k] for k in DETERMINISTIC} \
            == {k: w[k] for k in DETERMINISTIC}
        assert set(g["breakdown_ms"]) == set(w["breakdown_ms"])
        assert len(g["token_offsets_ms"]) == len(w["token_offsets_ms"])
    sw, sg = ref[2], got[2]
    assert set(sg) == set(sw) | {"step_seconds", "device"}
    assert set(sg["kv_blocks"]) == set(sw["kv_blocks"])
    assert sg["counts"] == sw["counts"]
    for k in ("decode_mode", "speculative", "multistep", "iterations",
              "killed", "closed", "consecutive_step_failures"):
        assert sg[k] == sw[k], k


def test_trace_spans_breakdown_and_sink(params, tmp_path, monkeypatch):
    _, pt = params
    log = tmp_path / "trace.jsonl"
    monkeypatch.setenv("TPUMX_TRACE_LOG", str(log))
    tracing.clear()
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(**GEN), start=False,
                               device="cpu")
    _, evs, _ = _serve(svc, [np.arange(7), np.arange(20) % 9], [{}, {}])
    for ev in evs:
        tid = ev["trace_id"]
        names = {s["name"] for s in tobs.recent_spans(trace_id=tid)}
        assert {"gen.queue", "gen.admit", "serving.prefill",
                "serving.decode.participate", "gen.reply"} <= names
        assert sum(ev["breakdown_ms"].values()) == pytest.approx(
            ev["total_ms"], abs=0.05)
        assert sum(ev["ttft_breakdown_ms"].values()) == pytest.approx(
            ev["ttft_ms"], abs=0.05)
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [e["request_id"] for e in lines] == [0, 1]
    ring = [e["request_id"] for e in tobs.recent_requests()]
    assert ring[-2:] == [0, 1]


def test_tracing_off_has_no_trace(params, monkeypatch):
    _, pt = params
    monkeypatch.setenv("TPUMX_TRACING", "0")
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(**GEN), start=False,
                               device="cpu")
    try:
        h = svc.submit(np.arange(5), max_new_tokens=2)
        svc.start()
        h.result(60)
    finally:
        svc.stop()
    assert h.trace_id is None and h.stats()["trace_id"] is None


def test_gauges_health_and_load(params):
    _, pt = params
    svc = tg.GenerationService(pt, tt.TransformerConfig(**DIMS),
                               tg.GenerationConfig(**GEN), start=False,
                               device="cpu")
    hs = [svc.submit(np.arange(6) + i, max_new_tokens=3) for i in range(3)]
    h0 = svc.health()
    assert h0["alive"] and h0["waiting"] == 3 and h0["running"] == 0
    assert svc.load() == pytest.approx(3.0)
    try:
        svc.start()
        for h in hs:
            h.result(60)
        live = hs[0].stats()
    finally:
        svc.stop()
    assert live["outcome"] == "finished"
    text = tobs.to_prometheus()
    for name in ("generation_running_requests", "generation_waiting_requests",
                 "generation_kv_blocks_used", "generation_kv_blocks_free",
                 "generation_kv_block_occupancy",
                 "generation_kv_block_live_occupancy",
                 "generation_tokens_per_sec", "generation_tokens_total",
                 "generation_requests_total", "generation_ttft_seconds"):
        assert f"# TYPE {name} " in text, name
    h1 = svc.health()
    assert h1["closed"] and not h1["alive"]
    assert svc.live_occupancy() == 0.0


@pytest.mark.parametrize("q", [0, 37.5, 50, 90, 99, 100])
def test_serving_metrics_percentile_and_snapshot(q):
    xs = list(np.random.RandomState(int(q)).rand(17))
    assert tsm.percentile(xs, q) == jsm.percentile(xs, q)
    assert tsm.percentile([], q) is None
    m = tsm.ServingMetrics(f"svc_{int(q)}")
    m.incr("requests")
    m.observe_latency(0.01)
    m.observe_batch(3, 4)
    snap = m.snapshot()
    ref = jsm.ServingMetrics(f"svc_{int(q)}")
    ref.incr("requests")
    ref.observe_latency(0.01)
    ref.observe_batch(3, 4)
    rsnap = ref.snapshot()
    assert set(snap) == set(rsnap)
    assert snap["batch_occupancy"] == rsnap["batch_occupancy"] == 0.75


# ---------------------------------------------------------------------------
# device-side train telemetry (the fused step's norms, loss and counters)
# ---------------------------------------------------------------------------

def _tele_data():
    r = np.random.RandomState(0)
    Y = r.randint(0, 4, 320).astype(np.float32)
    X = r.rand(320, 8).astype(np.float32) * 0.3
    for c in range(4):
        X[Y == c, c] += 1.0
    init = {"fc1_weight": (r.randn(16, 8) * 0.3).astype(np.float32),
            "fc1_bias": (r.randn(16) * 0.1).astype(np.float32),
            "fc2_weight": (r.randn(4, 16) * 0.3).astype(np.float32),
            "fc2_bias": (r.randn(4) * 0.1).astype(np.float32)}
    return X, Y, init


def _tele_fit(pkg, monkeypatch, telemetry_env=None, every="4",
              optimizer="sgd"):
    """The reference's ``_fit`` (one epoch of the toy MLP, 10 fused steps)
    from the same numpy parameters in ``pkg``: (module, parameters, the
    gauges published at step 8)."""
    if telemetry_env is None:
        monkeypatch.delenv("TPUMX_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("TPUMX_TELEMETRY", telemetry_env)
    monkeypatch.setenv("TPUMX_TELEMETRY_EVERY", every)
    X, Y, init = _tele_data()
    obs = jobs if pkg.__name__ == "mxnet_tpu" else tobs
    obs.reset()
    with pkg.name.NameManager():
        data, label = pkg.sym.Variable("data"), pkg.sym.Variable(
            "softmax_label")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            data, num_hidden=16, name="fc1"), act_type="relu")
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            h, num_hidden=4, name="fc2"), label, name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=32), num_epoch=1,
            optimizer=optimizer, optimizer_params=(("learning_rate", 0.5),),
            arg_params={k: pkg.nd.array(v) for k, v in init.items()})
    arg, _ = mod.get_params()
    gauges = {k: v for k, v in obs.snapshot()["gauges"].items()
              if k.startswith("train_")}
    return mod, {k: v.asnumpy() for k, v in arg.items()}, gauges


def _port_tele_fit(*a, **kw):
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        return _tele_fit(tmx, *a, **kw)


def test_telemetry_published_from_fit_equals_reference(monkeypatch):
    """``fit`` publishes the reference's gauges every
    ``TPUMX_TELEMETRY_EVERY`` fused steps with the reference's values
    (rtol 1e-5); the last step's snapshot matches too, and its norms equal
    the ones computed from ``get_params`` and the bound gradients."""
    import mxnet_tpu as jmx
    from mxnet_tpu.observability import telemetry as jtele
    from mxnet_tpu_torch.observability import telemetry as ttele

    jmod, _, jg = _tele_fit(jmx, monkeypatch)
    tmod, tparams, tg = _port_tele_fit(monkeypatch)
    assert tmod._fused_step_count == jmod._fused_step_count == 10
    want = ("train_grad_norm", "train_param_norm", "train_loss",
            "train_nonfinite_grads_total", "train_skip_steps_total")
    assert set(tg) == set(jg) and set(want) <= set(tg)
    for k in jg:
        assert tg[k] == pytest.approx(jg[k], rel=1e-5, abs=1e-7), k
    assert tg["train_grad_norm"] > 0 and tg["train_skip_steps_total"] == 0
    assert tobs.snapshot()["histograms"]["train_step_seconds"]["count"] \
        == 10
    jt_, tt_ = (tele.publish(m._exec.telemetry_snapshot())
                for tele, m in ((jtele, jmod), (ttele, tmod)))
    assert set(jt_) == set(tt_)
    for k in jt_:
        assert tt_[k] == pytest.approx(jt_[k], rel=1e-5, abs=1e-7), k
    pn = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                     for v in tparams.values()))
    assert tt_["param_norm"] == pytest.approx(pn, rel=1e-5)
    ex = tmod._exec
    gn = np.sqrt(sum(float((ex.grad_dict[n]._data.double() ** 2).sum())
                     for n in ex._grad_arg_names))
    assert tt_["grad_norm"] == pytest.approx(gn, rel=1e-5)


def test_telemetry_off_is_bitwise_and_reads_env(monkeypatch):
    """``TPUMX_TELEMETRY=0`` computes nothing (no snapshot, no gauges) and
    the parameters are bitwise those of the run with telemetry on; the
    variables parse as the reference's."""
    from mxnet_tpu.observability import telemetry as jtele
    from mxnet_tpu_torch.observability import telemetry as ttele

    off, p_off, g_off = _port_tele_fit(monkeypatch, telemetry_env="0")
    assert off._exec._telemetry_last is None
    assert off._exec.telemetry_snapshot() == {}
    assert "train_grad_norm" not in g_off
    on, p_on, g_on = _port_tele_fit(monkeypatch, telemetry_env="1")
    assert on._exec._telemetry_last is not None and g_on
    for k in p_off:
        np.testing.assert_array_equal(p_off[k], p_on[k])
    for env in ("0", "1", None):
        if env is None:
            monkeypatch.delenv("TPUMX_TELEMETRY", raising=False)
        else:
            monkeypatch.setenv("TPUMX_TELEMETRY", env)
        assert ttele.enabled() == jtele.enabled()
    for every in ("7", "0", "x"):
        monkeypatch.setenv("TPUMX_TELEMETRY_EVERY", every)
        assert ttele.every() == jtele.every()
    assert ttele.ACCUMULATING == jtele.ACCUMULATING


def test_telemetry_accumulates_overflow_counts(monkeypatch):
    """fp16 with a dynamic scaler over a clean batch, two batches holding
    an inf and a clean one: ``nonfinite_grad_count`` and ``skip_step`` add
    up across steps (the first batch overflows at the initial scale too:
    3 skipped steps in both packages), and the loss scale, norms and loss
    equal the reference's.  The non-finite count is each package's own
    gradients' (equal to their count in the bound gradient buffers): how
    many entries an inf input makes non-finite differs between the two
    packages' ReLU backwards (the port's gives 0 where the input is not
    positive even under a NaN cotangent), so the counts are compared per
    package, not across."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.observability import telemetry as jtele
    from mxnet_tpu_torch.observability import telemetry as ttele

    for k, v in (("TPUMX_AMP", "1"), ("TPUMX_AMP_DTYPE", "float16"),
                 ("TPUMX_AMP_LOSS_SCALE", "dynamic")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUMX_TELEMETRY", raising=False)
    X, Y, init = _tele_data()
    got = {}
    for pkg, tele in ((jmx, jtele), (tmx, ttele)):
        with pkg.cpu():
            with pkg.name.NameManager():
                data, label = pkg.sym.Variable("data"), pkg.sym.Variable(
                    "softmax_label")
                h = pkg.sym.Activation(pkg.sym.FullyConnected(
                    data, num_hidden=16, name="fc1"), act_type="relu")
                net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
                    h, num_hidden=4, name="fc2"), label, name="softmax")
            mod = pkg.mod.Module(net, context=pkg.cpu())
            mod.bind(data_shapes=[("data", (32, 8))],
                     label_shapes=[("softmax_label", (32,))])
            mod.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in init.items()})
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.5})
            assert mod._loss_scaler is not None
            counts = []
            for bad in (False, True, True, False):
                x = X[:32].copy()
                if bad:
                    x[0, 0] = np.inf
                assert mod._try_fused_step(pkg.io.DataBatch(
                    data=[pkg.nd.array(x)], label=[pkg.nd.array(Y[:32])]))
                ex = mod._exec
                counts.append(sum(
                    int((~np.isfinite(ex.grad_dict[n].asnumpy())).sum())
                    for n in ex._grad_arg_names))
                assert float(ex._telemetry_last["nonfinite_grad_count"]) \
                    == counts[-1]
            got[pkg.__name__] = (tele.publish(ex.telemetry_snapshot()),
                                 counts)
    (tv, tc), (jv, jc) = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    assert set(tv) == set(jv) and "loss_scale" in tv
    assert tv["skip_step"] == jv["skip_step"] == 3.0
    assert tv["nonfinite_grad_count"] == sum(tc) and tc[1] > 0
    assert jv["nonfinite_grad_count"] == sum(jc)
    assert [c > 0 for c in tc] == [c > 0 for c in jc]
    assert tv["loss_scale"] == jv["loss_scale"]
    for k in ("grad_norm", "param_norm", "loss"):
        assert tv[k] == pytest.approx(jv[k], rel=1e-3), k
