"""Dynamic micro-batcher: bounded request queue, per-bucket coalescing,
backpressure, deadlines.

PyTorch-port copy of ``mxnet_tpu/serving/batcher.py`` (it holds no array
code).  Arriving requests are keyed by their shape bucket and appended to
a per-bucket FIFO.  The dispatch worker always serves the bucket owning
the globally oldest request (no bucket starves), coalescing up to
``max_batch_size`` requests of that bucket and waiting at most
``batch_timeout_ms`` for stragglers, never past the earliest deadline in
the forming batch.

The queue is bounded (``queue_bound``) with three backpressure policies:

- ``block``  — submit() blocks until space frees (optionally bounded by a
  submit timeout);
- ``reject`` — submit() raises :class:`QueueFullError` at once;
- ``shed_oldest`` — the globally oldest *pending* request fails with
  :class:`RequestShedError` and the new one is admitted.

The generation engine uses the error types and the policy names.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Deque, List, Optional, Tuple

from ..base import MXNetError, getenv

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestShedError", "ServingClosedError", "ServingConfig",
           "Request", "MicroBatcher", "BACKPRESSURE_POLICIES"]

BACKPRESSURE_POLICIES = ("block", "reject", "shed_oldest")


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Bounded queue is full and the policy is ``reject`` (or a blocking
    submit timed out)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before its batch executed."""


class RequestShedError(ServingError):
    """The request was evicted by the ``shed_oldest`` policy."""


class ServingClosedError(ServingError):
    """submit() after stop()/drain."""


class ServingConfig:
    """Knobs for :class:`mxnet_tpu_torch.serving.InferenceService`.

    Every constructor default reads its ``TPUMX_SERVING_*`` environment
    variable first, so fleet-wide tuning needs no code change.
    """

    def __init__(self, max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 backpressure: Optional[str] = None,
                 default_deadline_ms: Optional[float] = None,
                 batch_buckets: Optional[List[int]] = None,
                 shape_buckets: Optional[List[Tuple[int, ...]]] = None,
                 amp_dtype: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 quantize: Optional[str] = "__env__",
                 quantize_calibration=None):
        from .bucketing import batch_buckets as _ladder

        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else getenv("TPUMX_SERVING_MAX_BATCH_SIZE", 8))
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else getenv("TPUMX_SERVING_BATCH_TIMEOUT_MS", 2.0))
        self.queue_bound = int(
            queue_bound if queue_bound is not None
            else getenv("TPUMX_SERVING_QUEUE_BOUND", 256))
        if self.queue_bound < 1:
            raise ValueError("queue_bound must be >= 1")
        self.backpressure = (
            backpressure if backpressure is not None
            else getenv("TPUMX_SERVING_BACKPRESSURE", "block"))
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, "
                f"got {self.backpressure!r}")
        env_deadline = os.environ.get("TPUMX_SERVING_DEADLINE_MS")
        if default_deadline_ms is not None:
            self.default_deadline_ms: Optional[float] = float(default_deadline_ms)
        elif env_deadline:
            self.default_deadline_ms = float(env_deadline)
        else:
            self.default_deadline_ms = None
        self.batch_buckets = (sorted(int(b) for b in batch_buckets)
                              if batch_buckets else _ladder(self.max_batch_size))
        self.shape_buckets = ([tuple(int(d) for d in s) for s in shape_buckets]
                              if shape_buckets else None)
        # low-precision inference: executor-backed models are served
        # through an amp.convert_symbol'd graph
        env_amp = os.environ.get("TPUMX_SERVING_AMP_DTYPE")
        self.amp_dtype: Optional[str] = (
            str(amp_dtype) if amp_dtype is not None
            else (env_amp or None))
        # int8 weight quantization: executor-backed models are served
        # through a quantization.convert_symbol'd graph (int8 weights
        # stored once with per-channel scales); TPUMX_QUANT=int8 is the
        # fleet switch, =0 or unset leaves every key and output as it was
        if quantize == "__env__":
            from .. import quantization as _q

            quantize = _q.active_dtype()
        elif quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8', got {quantize!r}")
        self.quantize: Optional[str] = quantize
        # a CalibrationTable (or a path to one, TPUMX_QUANT_CALIBRATION)
        # pins static activation scales; without one activations quantize
        # dynamically in the graph
        env_calib = os.environ.get("TPUMX_QUANT_CALIBRATION")
        self.quantize_calibration = (
            quantize_calibration if quantize_calibration is not None
            else (env_calib or None))
        # Prometheus exposition endpoint: when set, InferenceService serves
        # the process registry's /metrics on this port (0 = ephemeral)
        # through observability.exposition
        env_mport = os.environ.get("TPUMX_SERVING_METRICS_PORT")
        if metrics_port is not None:
            self.metrics_port: Optional[int] = int(metrics_port)
        elif env_mport not in (None, ""):
            self.metrics_port = int(env_mport)
        else:
            self.metrics_port = None

    def __repr__(self):
        return (f"ServingConfig(max_batch_size={self.max_batch_size}, "
                f"batch_timeout_ms={self.batch_timeout_ms}, "
                f"queue_bound={self.queue_bound}, "
                f"backpressure={self.backpressure!r}, "
                f"default_deadline_ms={self.default_deadline_ms}, "
                f"batch_buckets={self.batch_buckets}, "
                f"shape_buckets={self.shape_buckets}, "
                f"quantize={self.quantize!r})")


class Request:
    """One in-flight inference request."""

    __slots__ = ("data", "future", "deadline", "t_submit", "bucket_key",
                 "seq", "trace")

    def __init__(self, data, bucket_key, deadline: Optional[float], seq: int):
        self.data = data                  # dict name -> per-sample np array
        self.future: Future = Future()
        self.deadline = deadline          # absolute time.perf_counter() or None
        self.t_submit = time.perf_counter()
        self.bucket_key = bucket_key
        self.seq = seq
        self.trace = None   # TraceContext parked across the queue boundary

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) >= self.deadline

    def fail(self, exc: BaseException) -> bool:
        f = self.future
        if f.cancelled() or f.done():
            return False
        try:
            f.set_exception(exc)
            return True
        except Exception:  # raced a client-side cancel
            return False


class MicroBatcher:
    """Bounded, bucket-keyed coalescing queue (thread-safe)."""

    def __init__(self, config: ServingConfig, metrics=None):
        self._cfg = config
        self._metrics = metrics
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        # bucket_key -> FIFO of Requests; OrderedDict iteration gives us
        # bucket insertion order, but age order is tracked per request (seq)
        self._queues: "OrderedDict[tuple, Deque[Request]]" = OrderedDict()
        self._size = 0
        self._seq = 0
        self._closed = False

    # -- producer side ------------------------------------------------------------
    def put(self, data, bucket_key, deadline: Optional[float],
            timeout: Optional[float] = None, trace=None) -> Request:
        cfg = self._cfg
        with self._lock:
            if self._closed:
                raise ServingClosedError("service is shut down")
            if self._size >= cfg.queue_bound:
                if cfg.backpressure == "reject":
                    raise QueueFullError(
                        f"queue bound {cfg.queue_bound} reached")
                if cfg.backpressure == "shed_oldest":
                    shed = self._pop_oldest_locked()
                    if shed is not None:
                        shed.fail(RequestShedError(
                            "request shed under overload (shed_oldest)"))
                        if self._metrics is not None:
                            self._metrics.incr("requests_shed")
                else:  # block
                    t_end = (None if timeout is None
                             else time.perf_counter() + timeout)
                    while self._size >= cfg.queue_bound and not self._closed:
                        remaining = (None if t_end is None
                                     else t_end - time.perf_counter())
                        if remaining is not None and remaining <= 0:
                            raise QueueFullError(
                                f"blocking submit timed out after {timeout}s")
                        self._not_full.wait(remaining)
                    if self._closed:
                        raise ServingClosedError("service is shut down")
            req = Request(data, bucket_key, deadline, self._seq)
            req.trace = trace   # set before the worker can pop the request
            self._seq += 1
            self._queues.setdefault(bucket_key, deque()).append(req)
            self._size += 1
            if self._metrics is not None:
                self._metrics.gauge("queue_depth", self._size)
            self._not_empty.notify()
            return req

    def _pop_oldest_locked(self) -> Optional[Request]:
        best_key, best = None, None
        for key, q in self._queues.items():
            if q and (best is None or q[0].seq < best.seq):
                best_key, best = key, q[0]
        if best is None:
            return None
        self._queues[best_key].popleft()
        if not self._queues[best_key]:
            del self._queues[best_key]
        self._size -= 1
        self._not_full.notify()
        return best

    # -- consumer side ------------------------------------------------------------
    def get_batch(self, poll_interval: float = 0.05
                  ) -> Optional[List[Request]]:
        """Block until a batch is ready; None once closed AND drained.

        Serves the bucket of the globally oldest pending request; waits up
        to ``batch_timeout_ms`` (but never past the earliest deadline in
        the forming batch) for the bucket to fill to ``max_batch_size``.
        Expired requests are failed here with DeadlineExceededError and
        never reach the device.
        """
        cfg = self._cfg
        with self._lock:
            while True:
                self._purge_expired_locked()
                if self._size > 0:
                    break
                if self._closed:
                    return None
                self._not_empty.wait(poll_interval)
            lead = self._peek_oldest_locked()
            key = lead.bucket_key
            coalesce_end = time.perf_counter() + cfg.batch_timeout_ms / 1e3
            while (len(self._queues.get(key, ())) < cfg.max_batch_size
                   and not self._closed):
                now = time.perf_counter()
                wait_until = coalesce_end
                for r in self._queues.get(key, ()):
                    if r.deadline is not None:
                        wait_until = min(wait_until, r.deadline)
                if now >= wait_until:
                    break
                self._not_empty.wait(min(wait_until - now, poll_interval))
                self._purge_expired_locked()
                if key not in self._queues:      # whole bucket expired under us
                    return []
            q = self._queues.get(key)
            if not q:
                return []
            batch = []
            while q and len(batch) < cfg.max_batch_size:
                batch.append(q.popleft())
            if not q:
                del self._queues[key]
            self._size -= len(batch)
            if self._metrics is not None:
                self._metrics.gauge("queue_depth", self._size)
            self._not_full.notify_all()
            return batch

    def _peek_oldest_locked(self) -> Request:
        best = None
        for q in self._queues.values():
            if q and (best is None or q[0].seq < best.seq):
                best = q[0]
        return best

    def _purge_expired_locked(self) -> None:
        now = time.perf_counter()
        dead_keys = []
        purged = 0
        for key, q in self._queues.items():
            keep = deque(r for r in q if not self._expire_one(r, now))
            purged += len(q) - len(keep)
            if keep:
                self._queues[key] = keep
            else:
                dead_keys.append(key)
        for key in dead_keys:
            del self._queues[key]
        if purged:
            self._size -= purged
            if self._metrics is not None:
                self._metrics.gauge("queue_depth", self._size)
            self._not_full.notify_all()

    def _expire_one(self, req: Request, now: float) -> bool:
        if req.expired(now):
            req.fail(DeadlineExceededError(
                f"deadline exceeded after "
                f"{(now - req.t_submit) * 1e3:.1f}ms in queue"))
            if self._metrics is not None:
                self._metrics.incr("requests_expired")
            return True
        return False

    # -- lifecycle ----------------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        with self._lock:
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    for r in q:
                        r.fail(ServingClosedError("service shut down"))
                self._queues.clear()
                self._size = 0
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._lock:
            return self._size
