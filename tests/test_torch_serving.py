"""PyTorch port: ``serving.InferenceService`` (the micro-batcher, shape
bucketing over bound executors, warmup, backpressure, deadlines, error
isolation, drain, NaiveEngine, Gluon blocks and callables) and the
bucketing helpers, against the JAX package's ``tests/test_serving.py``.

Both packages' services serve the same requests over the same numpy
parameters: the outputs agree within f32 rtol 1e-5, and after a covering
``warmup`` the port binds no new executor (``stats()["compile_cache"]``:
a bind is where the port counts what the reference counts as a compile).
``Module.predict`` pads a partial final batch up to the bound batch (F5:
the port used to raise ``ImportError`` there).  The two shutdown cases of
``tests/test_fault_tolerance.py`` (graceful shutdown, SIGTERM through the
preemption hub) close the file.
"""
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DeadlineExceededError, InferenceService,
                                     QueueFullError, RequestShedError,
                                     ServingClosedError, ServingConfig,
                                     ServingError)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield
    # warmup marks each package's process warm
    jmx.observability.recompile.reset()
    tmx.observability.recompile.reset()


def _varlen_sym(pkg):
    """tanh -> sum over the (padded) length axis -> FC: zero padding of the
    length axis is exactly neutral, so bucket padding keeps outputs."""
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data")
        pooled = pkg.sym.sum(pkg.sym.Activation(data, act_type="tanh"),
                             axis=1)
        return pkg.sym.FullyConnected(pooled, num_hidden=5, name="fc")


def _params():
    r = np.random.RandomState(3)
    return {"fc_weight": (r.randn(5, 8) * 0.3).astype(np.float32),
            "fc_bias": (r.randn(5) * 0.1).astype(np.float32)}


def _varlen_module(pkg, batch=4):
    mod = pkg.mod.Module(_varlen_sym(pkg), data_names=("data",),
                         label_names=None, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (batch, 4, 8))], for_training=False)
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in _params().items()})
    return mod


def _oracle(x):
    p = _params()
    return np.tanh(x).sum(axis=0) @ p["fc_weight"].T + p["fc_bias"]


def _config(pkg, **over):
    kw = dict(max_batch_size=4, batch_timeout_ms=5.0,
              shape_buckets=[(4, 8), (8, 8)])
    kw.update(over)
    return pkg.serving.ServingConfig(**kw)


def _requests(n=24, seed=7):
    rng = np.random.RandomState(seed)
    shapes = [(3, 8), (5, 8), (7, 8), (4, 8), (8, 8), (1, 8)]
    return [rng.rand(*shapes[i % len(shapes)]).astype(np.float32)
            for i in range(n)]


# -- acceptance: mixed shapes from several threads, no bind after warmup ------
def test_mixed_shape_concurrent_no_bind_after_warmup():
    """Four client threads, six request shapes over two shape buckets: every
    output equals the reference service's on the same request (and the
    numpy oracle), no executor is bound after ``warmup``, and the stats
    are populated as the reference's."""
    reqs = _requests()
    jsvc = jmx.serving.InferenceService(_varlen_module(jmx), _config(jmx))
    jsvc.warmup([(3, 8), (8, 8)])
    want = [jsvc.predict(x, timeout=30).asnumpy() for x in reqs]
    jsvc.stop()
    svc = InferenceService(_varlen_module(tmx), _config(tmx))
    assert svc.warmup([(3, 8), (5, 8), (8, 8)]) == 6  # 2 shapes x 3 batches
    warm = svc.stats()
    assert warm["compile_cache"] == {"hits": 0, "misses": 6}
    misses0 = warm["process_compile_cache"]["misses"]
    got = [None] * len(reqs)
    errors = []

    def client(tid):
        try:
            for i in range(tid, len(reqs), 4):
                got[i] = svc.predict(reqs[i], timeout=30).asnumpy()
        except Exception as e:  # surfaced through the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for x, g, w in zip(reqs, got, want):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, _oracle(x), rtol=1e-4, atol=1e-5)
    stats = svc.stats()
    assert stats["requests_completed"] >= len(reqs)
    assert stats["compile_cache"]["misses"] == 6
    assert stats["compile_cache"]["hits"] > 0
    assert stats["compiled_signatures"] == 6
    assert stats["process_compile_cache"]["misses"] == misses0
    assert stats["latency_ms"]["p50"] is not None
    assert stats["latency_ms"]["p99"] is not None
    assert 0 < stats["batch_occupancy"] <= 1
    assert stats["queue_depth"] == 0 and stats["qps"] > 0
    assert set(stats) == set(jsvc.stats())
    svc.stop()


def test_batch_coalescing_and_bucket_padding():
    """Eight same-bucket requests in one window coalesce; single requests
    of every length 1..8 pad to their bucket and equal the reference's."""
    svc = InferenceService(_varlen_module(tmx),
                           _config(tmx, batch_timeout_ms=50.0))
    svc.warmup([(4, 8)])
    futs = [svc.submit(np.ones((4, 8), np.float32)) for _ in range(8)]
    for f in futs:
        f.result(30)
    stats = svc.stats()
    assert stats["batches"] < 8 and stats["avg_batch_size"] > 1
    svc.stop()
    jsvc = jmx.serving.InferenceService(_varlen_module(jmx),
                                        _config(jmx, batch_timeout_ms=0.0))
    svc = InferenceService(_varlen_module(tmx),
                           _config(tmx, batch_timeout_ms=0.0))
    rng = np.random.RandomState(1)
    for L in range(1, 9):
        x = rng.rand(L, 8).astype(np.float32)
        np.testing.assert_allclose(svc.predict(x, timeout=30).asnumpy(),
                                   jsvc.predict(x, timeout=30).asnumpy(),
                                   **TOL)
    svc.stop()
    jsvc.stop()


# -- deadlines ----------------------------------------------------------------
@pytest.mark.parametrize("default", [False, True])
def test_deadline_expiry(default):
    """A request whose deadline (its own, or the config's default) passes
    while the worker is busy fails with ``DeadlineExceededError`` without
    reaching the model."""
    gate = threading.Event()
    seen = []

    def slow_model(x):
        seen.append(x.shape[0])
        gate.wait(5)
        return x * 2

    svc = InferenceService(slow_model, ServingConfig(
        max_batch_size=1, batch_timeout_ms=0.0, queue_bound=8,
        default_deadline_ms=1.0 if default else None))
    first = svc.submit(np.ones((2,), np.float32), deadline_ms=10000)
    time.sleep(0.05)
    doomed = svc.submit(np.ones((2,), np.float32),
                        **({} if default else {"deadline_ms": 1.0}))
    time.sleep(0.05)
    gate.set()
    np.testing.assert_allclose(first.result(10).asnumpy(), 2.0)
    with pytest.raises(DeadlineExceededError):
        doomed.result(10)
    assert svc.stats().get("requests_expired", 0) >= 1
    assert len(seen) == 1
    svc.stop()


# -- error isolation ----------------------------------------------------------
def test_error_isolation_failing_request_spares_batch():
    def touchy_model(x):
        if (x.asnumpy() < 0).any():
            raise ValueError("poison")
        return x * 2

    svc = InferenceService(touchy_model, ServingConfig(
        max_batch_size=4, batch_timeout_ms=200.0, shape_buckets=[(3,)]))
    good = [svc.submit(np.full((3,), i + 1, np.float32)) for i in range(3)]
    bad = svc.submit(np.full((3,), -1, np.float32))
    for i, f in enumerate(good):
        np.testing.assert_allclose(f.result(30).asnumpy(), (i + 1) * 2.0)
    with pytest.raises(ServingError, match="poison"):
        bad.result(30)
    stats = svc.stats()
    assert stats.get("batch_retries_isolated", 0) >= 1
    assert stats.get("requests_failed", 0) == 1
    svc.stop()


# -- backpressure -------------------------------------------------------------
def _stalled_service(policy, queue_bound=2):
    gate = threading.Event()

    def slow_model(x):
        gate.wait(10)
        return x

    svc = InferenceService(slow_model, ServingConfig(
        max_batch_size=1, batch_timeout_ms=0.0, queue_bound=queue_bound,
        backpressure=policy))
    # the first request occupies the worker; the next queue_bound fill the
    # queue
    inflight = [svc.submit(np.zeros((1,), np.float32))]
    time.sleep(0.05)
    inflight += [svc.submit(np.zeros((1,), np.float32))
                 for _ in range(queue_bound)]
    return svc, gate, inflight


@pytest.mark.parametrize("policy", ["reject", "block", "shed_oldest"])
def test_backpressure(policy):
    svc, gate, inflight = _stalled_service(policy)
    fresh = None
    if policy == "reject":
        with pytest.raises(QueueFullError):
            svc.submit(np.zeros((1,), np.float32))
        assert svc.stats().get("requests_rejected", 0) == 1
    elif policy == "block":
        with pytest.raises(QueueFullError, match="timed out"):
            svc.submit(np.zeros((1,), np.float32), timeout=0.05)
    else:
        fresh = svc.submit(np.zeros((1,), np.float32))
    gate.set()
    if policy == "shed_oldest":
        # the oldest QUEUED request was shed to admit the fresh one
        with pytest.raises(RequestShedError):
            inflight[1].result(30)
        inflight = [inflight[0]] + inflight[2:] + [fresh]
        assert svc.stats().get("requests_shed", 0) == 1
    for f in inflight:
        f.result(30)
    svc.stop()


# -- drain / stop -------------------------------------------------------------
def test_drain_stop_and_context_manager():
    """``drain`` finishes the backlog and refuses later submits; ``stop``
    without a drain fails what is queued while the batch in flight still
    completes; the context manager drains."""
    def slowish(x):
        time.sleep(0.02)
        return x + 1

    svc = InferenceService(slowish, ServingConfig(
        max_batch_size=2, batch_timeout_ms=1.0, queue_bound=64))
    futs = [svc.submit(np.full((2,), i, np.float32)) for i in range(10)]
    svc.drain(timeout=30)
    for i, f in enumerate(futs):
        assert f.done()
        np.testing.assert_allclose(f.result(0).asnumpy(), i + 1.0)
    with pytest.raises(ServingClosedError):
        svc.submit(np.zeros((2,), np.float32))
    gate = threading.Event()

    def slow_model(x):
        gate.wait(10)
        return x

    svc = InferenceService(slow_model, ServingConfig(
        max_batch_size=1, batch_timeout_ms=0.0, queue_bound=8))
    first = svc.submit(np.zeros((1,), np.float32))
    time.sleep(0.05)
    pending = svc.submit(np.zeros((1,), np.float32))
    svc._batcher.close(drain=False)
    gate.set()
    first.result(30)
    with pytest.raises(ServingClosedError):
        pending.result(30)
    svc.stop()
    with InferenceService(lambda x: x * 3,
                          ServingConfig(max_batch_size=2)) as svc:
        f = svc.submit(np.ones((2,), np.float32))
    np.testing.assert_allclose(f.result(0).asnumpy(), 3.0)


# -- NaiveEngine --------------------------------------------------------------
def test_naive_engine_synchronous_mode():
    svc = InferenceService(_varlen_module(tmx), _config(tmx))
    svc.warmup([(4, 8)])
    with tmx.engine.NaiveEngine():
        x = np.random.RandomState(2).rand(4, 8).astype(np.float32)
        f = svc.submit(x)
        assert f.done()  # ran inline on the calling thread
        np.testing.assert_allclose(f.result(0).asnumpy(), _oracle(x),
                                   rtol=1e-4, atol=1e-5)
        assert svc.stats()["engine"] == "NaiveEngine"
    assert svc._worker is None  # no dispatch thread was started
    svc.stop()


# -- an Executor, a Gluon block, a callable -----------------------------------
def test_serving_executor_block_and_callable():
    """A bound Executor serves like its Module; a Gluon block (hybridized)
    returns its own forward on the same sample with no new signature after
    warmup, and equals the reference block's from the same weights; a
    callable gets the batch as an NDArray."""
    x = np.random.RandomState(4).rand(6, 8).astype(np.float32)
    ex = _varlen_sym(tmx).bind(
        ctx=tmx.cpu(), args={"data": tmx.nd.zeros((4, 4, 8)),
                             **{k: tmx.nd.array(v)
                                for k, v in _params().items()}},
        args_grad=None, grad_req="null")
    svc = InferenceService(ex, _config(tmx))
    svc.warmup([(8, 8)])
    np.testing.assert_allclose(svc.predict(x, timeout=30).asnumpy(),
                               _oracle(x), rtol=1e-4, atol=1e-5)
    svc.stop()
    nets = {}
    for pkg in (jmx, tmx):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(6, activation="relu", in_units=8),
                pkg.gluon.nn.Dense(3, in_units=6))
        net.initialize(ctx=pkg.cpu())
        r = np.random.RandomState(5)
        for p in net.collect_params().values():
            p.set_data(pkg.nd.array(r.randn(*p.shape).astype(np.float32)))
        net.hybridize()
        nets[pkg] = net
    jsvc = jmx.serving.InferenceService(nets[jmx], jmx.serving.ServingConfig(
        max_batch_size=4, batch_timeout_ms=1.0, shape_buckets=[(8,)]))
    svc = InferenceService(nets[tmx], ServingConfig(
        max_batch_size=4, batch_timeout_ms=1.0, shape_buckets=[(8,)]))
    svc.warmup([(8,)])
    misses0 = svc.stats()["compile_cache"]["misses"]
    got = svc.predict(x[0], timeout=30).asnumpy()
    want = nets[tmx](tmx.nd.array(x[:1])).asnumpy()[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jsvc.predict(x[0], timeout=30).asnumpy(),
                               **TOL)
    assert svc.stats()["compile_cache"]["misses"] == misses0
    svc.stop()
    jsvc.stop()
    seen = []

    def fn(batch):
        seen.append(type(batch).__name__)
        return batch * 2

    with InferenceService(fn, ServingConfig(max_batch_size=2)) as svc:
        np.testing.assert_allclose(svc.predict(x[0], timeout=30).asnumpy(),
                                   x[0] * 2)
    assert seen == ["NDArray"]
    with pytest.raises(MXNetError, match="cannot serve"):
        InferenceService(42)


# -- bucketing helpers --------------------------------------------------------
def test_bucketing_helpers_equal_reference():
    from mxnet_tpu import serving as jserving

    for name in ("next_pow2",):
        for n in (1, 2, 3, 5, 8, 9, 1000):
            assert getattr(serving, name)(n) == getattr(jserving, name)(n)
    assert serving.batch_buckets(6) == jserving.batch_buckets(6) \
        == [1, 2, 4, 6]
    assert serving.bucket_batch(99, [1, 2, 4, 8]) == 8
    for shape, buckets in (((3, 8), [(4, 8), (8, 8)]),
                           ((5, 8), [(4, 8), (8, 8)]), ((3, 5), None),
                           ((2, 9), [(4, 8)])):
        assert serving.bucket_shape(shape, buckets) == \
            jserving.bucket_shape(shape, buckets)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for fn, args in (("pad_sample", ((4, 3),)), ("pad_batch_rows", (5,))):
        np.testing.assert_array_equal(getattr(serving, fn)(x, *args),
                                      getattr(jserving, fn)(x, *args))
    samples = [np.ones((2, 3), np.float32), np.full((1, 4), 2, np.float32)]
    np.testing.assert_array_equal(
        serving.assemble_batch(samples, (2, 4), 4),
        jserving.assemble_batch(samples, (2, 4), 4))
    for bad in ((lambda m: m.pad_sample(np.ones((5, 3)), (4, 3))),
                (lambda m: m.pad_batch_rows(np.ones((5, 3)), 4)),
                (lambda m: m.pad_batch_rows(np.ones((0, 3)), 4))):
        for m in (serving, jserving):
            with pytest.raises(ValueError):
                bad(m)
    assert set(jserving.__all__) <= set(serving.__all__)


def test_overlong_request_rejected_at_enqueue():
    svc = InferenceService(_varlen_module(tmx), _config(tmx))
    try:
        with pytest.raises(ValueError, match="exceeds every configured"):
            svc.submit(np.random.rand(16, 8).astype(np.float32))
        out = svc.predict(np.random.rand(6, 8).astype(np.float32),
                          timeout=60)
        assert out.shape == (5,)
        assert svc.stats()["queue_depth"] == 0
    finally:
        svc.stop()


def test_serving_config_env_defaults_and_refusals(monkeypatch):
    """Every default from its ``TPUMX_SERVING_*`` variable as the
    reference's; the reference's refusals; ``quantize="int8"`` and
    ``TPUMX_QUANT=int8`` give the reference's ``quantize``."""
    env = {"TPUMX_SERVING_MAX_BATCH_SIZE": "16",
           "TPUMX_SERVING_BATCH_TIMEOUT_MS": "7.5",
           "TPUMX_SERVING_QUEUE_BOUND": "99",
           "TPUMX_SERVING_BACKPRESSURE": "reject",
           "TPUMX_SERVING_DEADLINE_MS": "250",
           "TPUMX_SERVING_AMP_DTYPE": "bfloat16",
           "TPUMX_SERVING_METRICS_PORT": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUMX_QUANT", raising=False)
    cfg, ref = ServingConfig(), jmx.serving.ServingConfig()
    for k in ("max_batch_size", "batch_timeout_ms", "queue_bound",
              "backpressure", "default_deadline_ms", "batch_buckets",
              "shape_buckets", "amp_dtype", "metrics_port", "quantize"):
        assert getattr(cfg, k) == getattr(ref, k), k
    assert cfg.batch_buckets == [1, 2, 4, 8, 16]
    assert repr(cfg) == repr(ref)
    for bad in (dict(backpressure="bogus"), dict(max_batch_size=0),
                dict(queue_bound=0), dict(quantize="int4")):
        with pytest.raises(ValueError):
            ServingConfig(**bad)
        with pytest.raises(ValueError):
            jmx.serving.ServingConfig(**bad)
    assert ServingConfig(quantize="int8").quantize == \
        jmx.serving.ServingConfig(quantize="int8").quantize == "int8"
    monkeypatch.setenv("TPUMX_QUANT", "int8")
    cfg, ref = ServingConfig(), jmx.serving.ServingConfig()
    assert cfg.quantize == ref.quantize == "int8"
    assert repr(cfg) == repr(ref)


def test_amp_dtype_serves_the_converted_graph():
    """``ServingConfig(amp_dtype="bfloat16")`` serves
    ``amp.convert_symbol``'s graph over the model's own parameters: the
    output dtype is the reference's (the FC output in bf16), the values
    equal the reference's bf16 service within the low-precision tolerance
    of ``tests/test_torch_amp.py`` (rtol 0.05), and they move when the
    model's weights are updated in place."""
    x = np.random.RandomState(6).rand(4, 8).astype(np.float32)
    outs, dtypes = {}, {}
    for pkg in (jmx, tmx):
        mod = _varlen_module(pkg)
        svc = pkg.serving.InferenceService(
            mod, _config(pkg, amp_dtype="bfloat16"))
        out = svc.predict(x, timeout=30)
        dtypes[pkg] = np.dtype(out.dtype).name if pkg is jmx \
            else str(out._data.dtype).replace("torch.", "")
        outs[pkg] = out.astype("float32").asnumpy()
        if pkg is tmx:
            base = svc._adapter._base
            assert "amp_cast" in base._symbol.tojson()
            w = mod._exec.arg_dict["fc_weight"]
            assert base.arg_dict["fc_weight"] is w
            w._data.mul_(2.0)
            moved = svc.predict(x, timeout=30).astype("float32").asnumpy()
        svc.stop()
    assert dtypes[tmx] == dtypes[jmx] == "bfloat16"
    np.testing.assert_allclose(outs[tmx], outs[jmx], rtol=0.05,
                               atol=0.05 * np.abs(outs[jmx]).max())
    np.testing.assert_allclose(outs[tmx], _oracle(x), rtol=0.05,
                               atol=0.05 * np.abs(outs[jmx]).max())
    assert not np.allclose(moved, outs[tmx])


# -- Module.predict on a partial final batch (F5) -----------------------------
class _PartialTailIter(tmx.io.DataIter):
    """Full batches, then one smaller final batch."""

    def __init__(self, pkg, X, batch_size):
        super().__init__(batch_size)
        self.pkg, self.X, self.pos = pkg, X, 0

    @property
    def provide_data(self):
        return [self.pkg.io.DataDesc("data",
                                     (self.batch_size,) + self.X.shape[1:])]

    @property
    def provide_label(self):
        return []

    def reset(self):
        self.pos = 0

    def __next__(self):
        if self.pos >= len(self.X):
            raise StopIteration
        chunk = self.X[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        return self.pkg.io.DataBatch(data=[self.pkg.nd.array(chunk)],
                                     label=None, pad=None)


def test_module_predict_pads_partial_final_batch():
    """40 rows at a bound batch of 16 (16 + 16 + 8): ``predict`` pads the
    tail to the bound batch instead of rebinding, equals the oracle
    ``relu(X) @ W.T + b`` and the reference's, and ``iter_predict`` gives
    the same rows."""
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(tmx.sym.Activation(
            data, act_type="relu"), num_hidden=3, name="fc")
    mod = tmx.mod.Module(net, data_names=("data",), label_names=None,
                         context=tmx.cpu())
    mod.bind(data_shapes=[("data", (16, 6))], for_training=False)
    r = np.random.RandomState(9)
    w = r.uniform(-0.1, 0.1, (3, 6)).astype(np.float32)
    b = r.uniform(-0.1, 0.1, 3).astype(np.float32)
    mod.init_params(arg_params={"fc_weight": tmx.nd.array(w),
                                "fc_bias": tmx.nd.array(b)})
    X = r.rand(40, 6).astype(np.float32)
    ex = mod._exec
    out = mod.predict(_PartialTailIter(tmx, X, 16))
    assert out.shape == (40, 3)
    assert mod._exec is ex  # the tail took the bound executor
    want = np.maximum(X, 0) @ w.T + b
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-6)
    rows = np.concatenate([o[0].asnumpy() for o, _, _ in
                           mod.iter_predict(_PartialTailIter(tmx, X, 16))])
    np.testing.assert_array_equal(rows, out.asnumpy())
    jnet = jmx.sym.FullyConnected(jmx.sym.Activation(
        jmx.sym.Variable("data"), act_type="relu"), num_hidden=3, name="fc")
    jmod = jmx.mod.Module(jnet, data_names=("data",), label_names=None,
                          context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (16, 6))], for_training=False)
    jmod.init_params(arg_params={"fc_weight": jmx.nd.array(w),
                                 "fc_bias": jmx.nd.array(b)})
    np.testing.assert_allclose(
        out.asnumpy(), jmod.predict(_PartialTailIter(jmx, X, 16)).asnumpy(),
        **TOL)


# -- graceful shutdown (tests/test_fault_tolerance.py) -------------------------
def _slow_service():
    started = threading.Event()

    def slow_model(x):
        started.set()
        time.sleep(0.4)
        return x

    svc = InferenceService(slow_model, config=ServingConfig(
        max_batch_size=1, batch_timeout_ms=0.1, queue_bound=64))
    return svc, started


def _outcomes(futs):
    done = rejected = 0
    for f in futs:
        try:
            f.result(timeout=30)
            done += 1
        except ServingClosedError:
            rejected += 1
    return done, rejected


def test_inference_service_shutdown_rejects_queued_drains_inflight():
    svc, started = _slow_service()
    futs = [svc.submit(np.zeros((4,), np.float32)) for _ in range(6)]
    assert started.wait(10)
    svc.shutdown(timeout=30)
    done, rejected = _outcomes(futs)
    assert done >= 1 and rejected >= 1 and done + rejected == 6
    with pytest.raises(ServingClosedError):
        svc.submit(np.zeros((4,), np.float32))


def test_inference_service_sigterm_installs_graceful_drain():
    """A real SIGTERM through the preemption hub: the batch in flight
    completes, the queued requests are rejected."""
    svc, started = _slow_service()
    assert svc.install_signal_handlers()
    try:
        futs = [svc.submit(np.zeros((4,), np.float32)) for _ in range(5)]
        assert started.wait(10)
        signal.raise_signal(signal.SIGTERM)
        done, rejected = _outcomes(futs)
        assert done >= 1 and rejected >= 1
    finally:
        svc.uninstall_signal_handlers()
        svc.stop(drain=False)


# -- a symbolic LayerNorm binds (F6) and serves ----------------------------------
def _ffn_block(pkg, width=16, ff=32):
    with pkg.name.NameManager():
        x = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(x, num_hidden=ff, flatten=False,
                                   name="ffn_1")
        h = pkg.sym.LeakyReLU(h, act_type="gelu")
        h = pkg.sym.FullyConnected(h, num_hidden=width, flatten=False,
                                   name="ffn_2")
        return pkg.sym.LayerNorm(h + x, name="ln")


def test_layer_norm_block_binds_and_serves():
    """A feed-forward block ending in ``LayerNorm`` (the chip's BERT-width
    block at a small width): ``Module.bind`` infers its shapes (F6: the
    shape solver's meta tensors reached the LayerNorm kernel's wrapper and
    the bind raised), its ``predict`` equals the reference Module's, and
    ``InferenceService`` serves it to the same rows with no bind after
    warmup."""
    r = np.random.RandomState(11)
    params = {"ffn_1_weight": r.randn(32, 16) * 0.2,
              "ffn_1_bias": r.randn(32) * 0.1,
              "ffn_2_weight": r.randn(16, 32) * 0.2,
              "ffn_2_bias": r.randn(16) * 0.1,
              "ln_gamma": 1 + 0.1 * r.randn(16), "ln_beta": 0.1 * r.randn(16)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    X = r.randn(10, 8, 16).astype(np.float32)
    outs = {}
    for pkg in (jmx, tmx):
        mod = pkg.mod.Module(_ffn_block(pkg), label_names=None,
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (4, 8, 16))], for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in params.items()})
        outs[pkg] = mod.predict(pkg.io.NDArrayIter(X, batch_size=4))
        if pkg is tmx:
            tmod = mod
    want = outs[tmx].asnumpy()
    np.testing.assert_allclose(want, outs[jmx].asnumpy(), rtol=1e-5,
                               atol=1e-5)
    svc = InferenceService(tmod, ServingConfig(
        max_batch_size=4, batch_timeout_ms=1.0, shape_buckets=[(8, 16)]))
    try:
        svc.warmup()
        binds = svc.stats()["compile_cache"]["misses"]
        got = np.stack([f.result(30).asnumpy()
                        for f in [svc.submit(x) for x in X]])
        np.testing.assert_allclose(got, want, **TOL)
        assert svc.stats()["compile_cache"]["misses"] == binds
    finally:
        svc.stop()
