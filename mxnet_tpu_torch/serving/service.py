"""InferenceService: online serving for bound symbols, Modules, Gluon
blocks and callables.

PyTorch counterpart of ``mxnet_tpu/serving/service.py`` (the inference
analogue of the reference's C predict API): keep the device fed under
concurrent request load.

- a dynamic micro-batcher (:mod:`.batcher`) coalesces concurrent
  ``submit()`` calls up to ``max_batch_size`` / ``batch_timeout_ms``;
- shape bucketing (:mod:`.bucketing`) lands arbitrary request shapes on a
  small fixed set of bound executors: each (batch bucket × shape bucket)
  signature binds ONE executor over the model's own parameter arrays
  (shared, not copied), and that bind is what the port counts where the
  reference counts a compile (``stats()["compile_cache"]``, and the
  ``TPUMX_FREEZE_COMPILES`` watchdog after ``warmup``);
- :meth:`InferenceService.warmup` binds every (batch bucket × shape
  bucket) executor and runs it once before traffic arrives;
- a bounded queue with block / reject / shed-oldest backpressure,
  per-request deadlines, per-request error isolation, and a graceful
  drain;
- serving metrics (queue depth, batch occupancy, latency percentiles,
  QPS, bind hits and misses) in :meth:`InferenceService.stats`.

The executors run the same ops as ``Module.forward`` on the model's
device (cuDNN and cuBLAS for convolutions and GEMMs, the port's LayerNorm
kernel for ``LayerNorm``).  The dispatch worker runs under the context
that was current when the service was made; a Gluon block's inputs go to
its parameters' device.

``MXNET_ENGINE_TYPE=NaiveEngine`` (or the ``engine.NaiveEngine`` scope)
makes the pipeline synchronous: ``submit()`` runs inline on the calling
thread through the same bucketing and padding path.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import engine as _engine
from .. import observability as _obs
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..observability import recompile as _recompile
from .batcher import (MicroBatcher, Request, ServingClosedError, ServingConfig,
                      ServingError)
from .bucketing import assemble_batch, bucket_batch, bucket_shape
from .metrics import ServingMetrics

__all__ = ["InferenceService"]

# process-wide bind hits and misses of every service's adapter (the
# reference reports its executor compile cache here)
_PROCESS_BINDS = {"hits": 0, "misses": 0}
_PROCESS_LOCK = threading.Lock()


def _scope_context():
    """The context current where the service is made (the dispatch worker
    runs under it), or None on a machine without CUDA outside any ``with
    ctx:`` scope."""
    try:
        return current_context()
    except MXNetError:
        return None


def _as_sample(x) -> _np.ndarray:
    if isinstance(x, NDArray):
        x = x.asnumpy()
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = _np.asarray(x)
    if arr.dtype == _np.float64:
        # f64 arrives as f32 on the device anyway; normalized here so the
        # bucket key (which includes the dtype) is stable
        arr = arr.astype(_np.float32)
    return arr


class _CompileCounter:
    """One adapter's bind hits and misses (``stats()`` is not polluted by
    other executors in the process)."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def note(self, hit: bool, site: str, key: tuple) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        with _PROCESS_LOCK:
            _PROCESS_BINDS["hits" if hit else "misses"] += 1
        # a miss after warmup raises under TPUMX_FREEZE_COMPILES=1
        _recompile.note_cache(hit, ("serving", (site,)), key)

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses}


# -- model adapters -----------------------------------------------------------
class _ExecutorAdapter:
    """Serve a bound :class:`~mxnet_tpu_torch.executor.Executor` through a
    signature-keyed cache of executors, one per bucket signature, each
    bound over the base executor's own parameter and aux arrays.

    ``amp_dtype`` (``ServingConfig.amp_dtype`` /
    ``TPUMX_SERVING_AMP_DTYPE``) serves the ``amp.convert_symbol`` graph
    instead: the matmul and convolution family run in bf16/fp16, the
    softmax and norm outputs stay f32; the parameters are still the
    original executor's (the casts are in the graph), so
    ``refresh_params`` after a weight update keeps working.

    ``quantize="int8"`` (``ServingConfig.quantize`` / ``TPUMX_QUANT``)
    serves ``quantization.convert_symbol``'s graph: the weights are
    quantized once, here, into int8 arrays on the model's device with
    per-output-channel f32 scales (no f32 copy of a quantized weight is
    kept beside them); activations take the static scales of
    ``quantize_calibration`` (a ``CalibrationTable`` or a path to one),
    or a dynamic absmax without one; ``refresh_params`` quantizes again
    from the float executor."""

    def __init__(self, base_exec, data_names: Sequence[str],
                 label_shapes: Optional[Sequence[Tuple[str, Tuple[int, ...]]]]
                 = None, amp_dtype: Optional[str] = None,
                 quantize: Optional[str] = None, quantize_calibration=None):
        if amp_dtype:
            from .. import amp as _amp

            conv = _amp.convert_symbol(base_exec._symbol, amp_dtype)
            base_exec = conv.bind(
                ctx=base_exec._ctx, args=base_exec.arg_dict, args_grad=None,
                grad_req="null", aux_states=base_exec.aux_dict)
        self._float_base = base_exec
        self._quantize = quantize
        self._quant_table = None
        if quantize:
            from .. import quantization as _q

            table = quantize_calibration
            if isinstance(table, str):
                table = _q.CalibrationTable.load(table)
            self._quant_table = table
            base_exec = self._quantized_bind(base_exec, table)
        self._base = base_exec
        self.input_names = list(data_names)
        self._label_shapes = list(label_shapes or [])
        self._cache: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self.counter = _CompileCounter()

    def _quantized_args(self) -> Dict[str, object]:
        from .. import quantization as _q

        base = self._float_base
        return _q.quantize_weights(base._symbol, dict(base.arg_dict),
                                   table=self._quant_table)

    def _quantized_bind(self, base_exec, table):
        from .. import nd as _nd
        from .. import quantization as _q

        sym = base_exec._symbol
        shapes = {k: tuple(v.shape) for k, v in base_exec.arg_dict.items()}
        qsym = _q.convert_symbol(sym, table, param_shapes=shapes)
        args = {k: (v if isinstance(v, NDArray)
                    else _nd.array(v, ctx=base_exec._ctx))
                for k, v in self._quantized_args().items()}
        return qsym.bind(ctx=base_exec._ctx, args=args, args_grad=None,
                         grad_req="null",
                         aux_states=dict(base_exec.aux_dict))

    def _bind(self, shape_kwargs: Dict[str, tuple], dtypes: Dict[str, str]):
        """One executor at the bucket's input shapes over the base's
        parameter and aux arrays (a parameter whose inferred shape changes
        with the input gets its own zeros, as the reference's reshape
        gives it)."""
        from ..ndarray import zeros

        base = self._base
        sym = base._symbol
        arg_shapes, _, _ = sym.infer_shape(**shape_kwargs)
        args = {}
        for n, sh in zip(sym.list_arguments(), arg_shapes):
            have = base.arg_dict.get(n)
            if n in shape_kwargs or have is None \
                    or tuple(have.shape) != tuple(sh):
                like = have._data.dtype if have is not None else None
                args[n] = zeros(sh, ctx=base._ctx,
                                dtype=dtypes.get(n) or like or "float32")
            else:
                args[n] = have
        return sym.bind(ctx=base._ctx, args=args, args_grad=None,
                        grad_req="null", aux_states=base.aux_dict)

    def _executor_for(self, sig: tuple):
        with self._lock:
            ex = self._cache.get(sig)
            self.counter.note(ex is not None, "executor", sig)
            if ex is not None:
                return ex
            feeds = sig[:len(self.input_names)]
            shape_kwargs = {name: tuple(shape) for name, shape, _dt in feeds}
            dtypes = {name: dt for name, _shape, dt in feeds}
            batch = next(iter(shape_kwargs.values()))[0]
            for lname, lshape in self._label_shapes:
                # labels are never fed at inference; their shape follows
                # the bucket's batch so shape inference stays consistent
                shape_kwargs.setdefault(lname, (batch,) + tuple(lshape[1:]))
            ex = self._bind(shape_kwargs, dtypes)
            self._cache[sig] = ex
            return ex

    def run(self, feed: Dict[str, _np.ndarray]) -> List[torch.Tensor]:
        sig = tuple((n, tuple(feed[n].shape), str(feed[n].dtype))
                    for n in self.input_names)
        ex = self._executor_for(sig)
        with torch.no_grad():
            outs = ex.forward(is_train=False,
                              **{n: torch.from_numpy(
                                  _np.ascontiguousarray(feed[n]))
                                 for n in self.input_names})
        return [o._data for o in outs]

    def refresh_params(self) -> None:
        """Carry the base executor's parameters into every cached
        executor.  They share the base's arrays, so an in-place update is
        already seen; this re-links arrays the model replaced since.
        Under ``quantize`` the float executor stays the source: its
        weights are quantized again into the int8 base's arrays first."""
        inputs = set(self.input_names) | {n for n, _ in self._label_shapes}
        if self._quantize:
            self._base.copy_params_from(
                {n: v for n, v in self._quantized_args().items()
                 if n not in inputs}, dict(self._float_base.aux_dict),
                allow_extra_params=True)
        with self._lock:
            for ex in self._cache.values():
                for n, a in self._base.arg_dict.items():
                    if n not in inputs and n in ex.arg_dict and \
                            tuple(ex.arg_dict[n].shape) == tuple(a.shape):
                        ex.arg_dict[n] = a
                ex.aux_dict = self._base.aux_dict

    def compiled_signatures(self) -> int:
        with self._lock:
            return len(self._cache)


class _BlockAdapter:
    """Serve a Gluon block (hybridized or not): the block called on the
    batch under ``torch.no_grad()`` (inference mode); a new input shape is
    its miss (a hybridized block captures its CUDA graphs per shape)."""

    def __init__(self, block):
        self._block = block
        self.input_names = ["data"]
        self._seen: set = set()
        self._lock = threading.Lock()
        self.counter = _CompileCounter()

    def run(self, feed: Dict[str, _np.ndarray]) -> List[torch.Tensor]:
        from .. import nd

        x = feed["data"]
        with self._lock:
            key = (tuple(x.shape), str(x.dtype))
            self.counter.note(key in self._seen, "block", key)
            self._seen.add(key)
        ctx = None
        for p in self._block.collect_params().values():
            ctx = p.list_ctx()[0] if p._data is not None else None
            break
        with torch.no_grad():
            out = self._block(nd.array(x, ctx=ctx))
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        return [o._data if isinstance(o, NDArray) else o for o in out]

    def refresh_params(self) -> None:
        pass  # the block's own parameters are what it runs

    def compiled_signatures(self) -> int:
        with self._lock:
            return len(self._seen)


class _CallableAdapter:
    """Serve any ``fn(batch NDArray) -> NDArray | list`` (a dict of
    NDArrays for several inputs); caching is whatever fn does."""

    def __init__(self, fn, data_names: Sequence[str]):
        self._fn = fn
        self.input_names = list(data_names)
        self._seen: set = set()
        self._lock = threading.Lock()
        self.counter = _CompileCounter()

    def run(self, feed: Dict[str, _np.ndarray]) -> List[torch.Tensor]:
        from .. import nd

        key = tuple((n, tuple(feed[n].shape), str(feed[n].dtype))
                    for n in self.input_names)
        with self._lock:
            self.counter.note(key in self._seen, "callable", key)
            self._seen.add(key)
        if len(self.input_names) == 1:
            out = self._fn(nd.array(feed[self.input_names[0]]))
        else:
            out = self._fn({n: nd.array(feed[n]) for n in self.input_names})
        if not isinstance(out, (list, tuple)):
            out = [out]
        return [o._data if isinstance(o, NDArray) else torch.as_tensor(o)
                for o in out]

    def refresh_params(self) -> None:
        pass

    def compiled_signatures(self) -> int:
        with self._lock:
            return len(self._seen)


def _make_adapter(model, data_names, amp_dtype=None, quantize=None,
                  quantize_calibration=None):
    # duck-typed: Module-likes carry a bound executor and data_names; raw
    # executors arg_dict/forward; Gluon blocks collect_params
    quant = dict(amp_dtype=amp_dtype, quantize=quantize,
                 quantize_calibration=quantize_calibration)
    if hasattr(model, "_exec") and hasattr(model, "data_names"):
        if not (getattr(model, "binded", False)
                and getattr(model, "params_initialized", False)):
            raise MXNetError("InferenceService: Module must be bound and "
                             "have initialized params")
        label_shapes = [(n, tuple(s)) for n, s in (model.label_shapes or [])]
        return _ExecutorAdapter(model._exec,
                                data_names or model.data_names,
                                label_shapes, **quant)
    if hasattr(model, "arg_dict") and hasattr(model, "forward"):
        return _ExecutorAdapter(model, data_names or ["data"], **quant)
    if hasattr(model, "collect_params") and callable(model):
        return _BlockAdapter(model)
    if callable(model):
        return _CallableAdapter(model, data_names or ["data"])
    raise MXNetError(f"InferenceService: cannot serve {type(model).__name__}")


# -- the service --------------------------------------------------------------
class InferenceService:
    """Concurrent online inference over a bound model.

    Parameters
    ----------
    model : Module | Executor | gluon.Block | callable
        The thing to serve.  Modules must be bound with initialized
        params; blocks initialized.
    config : ServingConfig, optional
        Batching and backpressure knobs; defaults read ``TPUMX_SERVING_*``.
    data_names : list of str, optional
        Input names for executor-backed models (default: the module's).

    A request is ONE sample (no batch axis), a numpy/NDArray value or a
    ``{input_name: value}`` dict; the service batches, pads, executes and
    returns each request's outputs with the padding stripped.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 data_names: Optional[Sequence[str]] = None):
        self._config = config or ServingConfig()
        self._adapter = _make_adapter(
            model, data_names, amp_dtype=self._config.amp_dtype,
            quantize=self._config.quantize,
            quantize_calibration=self._config.quantize_calibration)
        self._ctx = _scope_context()
        self._metrics = ServingMetrics()
        self._batcher = MicroBatcher(self._config, self._metrics)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._warmed: set = set()
        # optional Prometheus endpoint (TPUMX_SERVING_METRICS_PORT /
        # ServingConfig.metrics_port): the process-wide registry, serving
        # and train metrics alike
        self._metrics_server = None
        if self._config.metrics_port is not None:
            self._metrics_server = _obs.exposition.start_http_server(
                self._config.metrics_port)

    # -- submission -----------------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None):
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        ``deadline_ms`` bounds the queue-plus-execute time (default
        ``config.default_deadline_ms``); an expired request fails with
        :class:`DeadlineExceededError` without touching the device.
        ``timeout`` bounds a *blocking* submit under the ``block``
        policy."""
        if self._batcher.closed:
            raise ServingClosedError("service is shut down")
        sample = self._normalize(data)
        key = self._bucket_key(sample)
        ms = deadline_ms if deadline_ms is not None \
            else self._config.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3
        self._metrics.incr("requests_submitted")
        # per-request trace: the caller's context when one is active, else
        # a fresh root, parked on the request across the queue
        tr_ctx = _obs.tracing.current_trace() or _obs.tracing.new_trace()
        if _engine.is_naive():
            # synchronous debug mode: the same pad/bucket/execute path on
            # the calling thread
            req = Request(sample, key, deadline, seq=0)
            req.trace = tr_ctx
            if req.expired():
                from .batcher import DeadlineExceededError

                req.fail(DeadlineExceededError("deadline exceeded"))
            else:
                self._run_batch([req])
            return req.future
        self._ensure_worker()
        from .batcher import QueueFullError

        try:
            with _obs.span("serving.enqueue", cat="serving", ctx=tr_ctx):
                req = self._batcher.put(sample, key, deadline,
                                        timeout=timeout, trace=tr_ctx)
        except QueueFullError:
            self._metrics.incr("requests_rejected")
            raise
        return req.future

    def predict(self, data, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(data, deadline_ms=deadline_ms).result(timeout)

    def _normalize(self, data) -> Dict[str, _np.ndarray]:
        names = self._adapter.input_names
        if isinstance(data, dict):
            missing = [n for n in names if n not in data]
            if missing:
                raise MXNetError(f"request missing inputs {missing}")
            return {n: _as_sample(data[n]) for n in names}
        if len(names) != 1:
            raise MXNetError(
                f"model has inputs {names}; pass a dict request")
        return {names[0]: _as_sample(data)}

    def _bucket_key(self, sample: Dict[str, _np.ndarray]) -> tuple:
        buckets = self._config.shape_buckets
        if buckets:
            # with an explicit bucket ladder an over-sized sample is
            # refused AT ENQUEUE: bucket_shape's power-of-two fallback
            # would bind an executor nobody planned (and warmed)
            for n in self._adapter.input_names:
                shape = tuple(int(d) for d in sample[n].shape)
                same_rank = [b for b in buckets if len(b) == len(shape)]
                if same_rank and not any(
                        all(bd >= sd for bd, sd in zip(b, shape))
                        for b in same_rank):
                    raise ValueError(
                        f"request input {n!r} shape {shape} exceeds every "
                        f"configured shape bucket {same_rank}; add a larger "
                        f"bucket (and warm it) to serve this shape")
        return tuple(
            (n, bucket_shape(sample[n].shape, self._config.shape_buckets),
             str(sample[n].dtype))
            for n in self._adapter.input_names)

    # -- warmup ---------------------------------------------------------------
    def warmup(self, sample_shapes: Optional[Sequence] = None,
               dtype=_np.float32) -> int:
        """Bind and run every (shape bucket × batch bucket) executor.

        ``sample_shapes``: representative per-sample shapes (tuples, or
        ``{input: shape}`` dicts for several inputs); default
        ``config.shape_buckets``.  Returns the number bound by this call.
        After a covering warmup a steady service binds nothing more."""
        shapes = sample_shapes if sample_shapes is not None \
            else self._config.shape_buckets
        if not shapes:
            raise MXNetError("warmup needs sample_shapes (or a config with "
                             "shape_buckets)")
        names = self._adapter.input_names
        todo = []
        queued = set()
        for s in shapes:
            if isinstance(s, dict):
                per_input = {n: bucket_shape(tuple(s[n]),
                                             self._config.shape_buckets)
                             for n in names}
            else:
                if len(names) != 1:
                    raise MXNetError("multi-input model: warmup shapes must "
                                     "be dicts")
                per_input = {names[0]: bucket_shape(
                    tuple(s), self._config.shape_buckets)}
            for b in self._config.batch_buckets:
                sig = (b, tuple(sorted(per_input.items())))
                if sig not in self._warmed and sig not in queued:
                    queued.add(sig)
                    todo.append((b, per_input, sig))
        compiled = 0
        with self._ctx or contextlib.nullcontext():
            for b, per_input, sig in todo:
                feed = {n: _np.zeros((b,) + sh, dtype=dtype)
                        for n, sh in per_input.items()}
                with _obs.span("serving.warmup", cat="serving"):
                    self._adapter.run(feed)
                self._warmed.add(sig)
                compiled += 1
        if compiled:
            self._metrics.incr("warmup_programs", compiled)
        # a covering warmup is where the no-new-bind contract starts: with
        # TPUMX_FREEZE_COMPILES=1 a later miss raises
        _obs.mark_warm()
        return compiled

    # -- dispatch -------------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                t = threading.Thread(target=self._worker_loop,
                                     name="tpumx-serving-dispatch",
                                     daemon=True)
                self._worker = t
                t.start()

    def _worker_loop(self) -> None:
        with self._ctx or contextlib.nullcontext():
            while True:
                batch = self._batcher.get_batch()
                if batch is None:
                    return
                if not batch:
                    continue
                try:
                    self._run_batch(batch)
                except Exception as exc:  # noqa: BLE001 — the worker must
                    # outlive any per-batch surprise; strand no future
                    for r in batch:
                        r.fail(ServingError(f"dispatch failed: {exc!r}"))

    def _run_batch(self, requests: List[Request],
                   _isolated: bool = False) -> None:
        live = [r for r in requests if not r.future.cancelled()]
        if not live:
            return
        cfg = self._config
        n = len(live)
        padded = bucket_batch(n, cfg.batch_buckets)
        t0 = time.perf_counter()
        try:
            with _obs.span("serving.batch", cat="serving",
                           args={"real": n, "padded": padded}):
                with _obs.span("serving.assemble", cat="serving"):
                    feed = {}
                    for name, sample_bucket, _dt in live[0].bucket_key:
                        feed[name] = assemble_batch(
                            [r.data[name] for r in live], sample_bucket,
                            padded)
                t_exec0 = time.perf_counter()
                with _obs.span("serving.execute", cat="serving"):
                    outs = self._adapter.run(feed)
                t_exec1 = time.perf_counter()
                # one shared execute, one participation span per rider
                for r in live:
                    if r.trace is not None:
                        _obs.tracing.record_event(
                            "serving.execute.participate", "serving",
                            t_exec0, t_exec1, ctx=r.trace,
                            args={"batch": n, "padded": padded})
        except Exception as exc:  # noqa: BLE001 — isolate, then surface
            if n == 1 or _isolated:
                self._metrics.incr("requests_failed", n)
                for r in live:
                    r.fail(exc if isinstance(exc, ServingError)
                           else ServingError(f"inference failed: {exc!r}"))
                return
            # error isolation: a failed batch is retried one request at a
            # time so only the poisonous request(s) fail
            self._metrics.incr("batch_retries_isolated")
            for r in live:
                self._run_batch([r], _isolated=True)
            return
        now = time.perf_counter()
        self._metrics.observe_batch(real=n, padded=padded)
        with _obs.span("serving.reply", cat="serving"):
            for i, r in enumerate(live):
                rows = [out[i] for out in outs]
                result = NDArray(rows[0]) if len(rows) == 1 \
                    else [NDArray(x) for x in rows]
                try:
                    r.future.set_result(result)
                except Exception:  # cancelled/raced — drop on the floor
                    continue
                self._metrics.observe_latency(now - r.t_submit)
                self._metrics.observe_queue_wait(t0 - r.t_submit)

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """One coherent snapshot of the service's health counters."""
        out = self._metrics.snapshot()
        out["queue_depth"] = self._batcher.depth()
        out["compile_cache"] = self._adapter.counter.snapshot()
        out["compiled_signatures"] = self._adapter.compiled_signatures()
        with _PROCESS_LOCK:
            out["process_compile_cache"] = dict(_PROCESS_BINDS)
        out["engine"] = _engine.current_engine_type()
        out["closed"] = self._batcher.closed
        out["config"] = {
            "max_batch_size": self._config.max_batch_size,
            "batch_timeout_ms": self._config.batch_timeout_ms,
            "queue_bound": self._config.queue_bound,
            "backpressure": self._config.backpressure,
            "batch_buckets": list(self._config.batch_buckets),
            "shape_buckets": self._config.shape_buckets,
        }
        return out

    def refresh_params(self) -> None:
        """Push updated model weights into every cached bucket executor."""
        self._adapter.refresh_params()

    # -- lifecycle ------------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, finish the backlog, stop the worker."""
        self.stop(drain=True, timeout=timeout)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Shut down.  ``drain=True`` completes queued requests first;
        ``drain=False`` fails them with :class:`ServingClosedError`."""
        self._batcher.close(drain=drain)
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout)
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self.uninstall_signal_handlers()

    close = stop

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Graceful preemption shutdown: new submits raise
        :class:`ServingClosedError`, QUEUED requests are rejected with it,
        and the batch on the device completes and delivers — bounded
        work, no stranded futures."""
        _obs.registry().counter(
            "serving_graceful_shutdowns_total",
            help="graceful (signal-driven) service shutdowns").inc()
        # close(drain=False) fails every queued request; the in-flight
        # batch was already popped by the worker and runs to completion
        self.stop(drain=False, timeout=timeout)

    def install_signal_handlers(self, signals=None) -> bool:
        """Drain on SIGTERM/SIGINT (``fault.preemption``): in-flight
        requests complete, queued ones are rejected.  False when handlers
        cannot be installed from this thread (call from the main
        thread)."""
        from ..fault.preemption import DEFAULT_SIGNALS, install_shutdown_hook

        if getattr(self, "_signal_unregister", None) is not None:
            return True
        self._signal_unregister = install_shutdown_hook(
            lambda signum: self.shutdown(),
            signals or DEFAULT_SIGNALS)
        return self._signal_unregister is not None

    def uninstall_signal_handlers(self) -> None:
        unreg = getattr(self, "_signal_unregister", None)
        if unreg is not None:
            self._signal_unregister = None
            unreg()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)
