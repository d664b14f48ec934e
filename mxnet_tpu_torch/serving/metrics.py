"""Serving metrics: counters, latency percentiles, QPS.

PyTorch counterpart of ``mxnet_tpu/serving/metrics.py``.  Backed by the
process-wide :mod:`mxnet_tpu_torch.observability` registry: every
counter/gauge lands in a
``serving_*`` family labeled by service name, latencies and queue waits
feed registry histograms, and a pull-style collector publishes the
sliding-window values (QPS, p50/p99) as gauges — so
``observability.snapshot()`` and a Prometheus scrape show serving health
next to train telemetry.  Counters are also mirrored through
:mod:`mxnet_tpu_torch.profiler` ``Counter`` objects under a ``serving`` Domain,
so a running profiler sees queue depth, batch occupancy and request counts
as chrome://tracing counter tracks next to the operator spans;
``snapshot()`` serves the same numbers as a plain dict (the router's
``stats()``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .. import observability as _obs
from .. import profiler as _profiler

__all__ = ["ServingMetrics", "percentile"]

# sliding-window sizes: big enough for stable tail percentiles, small
# enough that a long-lived service never grows without bound
_LATENCY_WINDOW = 4096
_QPS_WINDOW_SEC = 30.0


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) over a non-empty list."""
    if not samples:
        return None
    xs = sorted(samples)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


class ServingMetrics:
    def __init__(self, name: str = "serving"):
        self._lock = threading.Lock()
        self._name = name
        self._domain = _profiler.Domain(name)
        self._counters: Dict[str, _profiler.Counter] = {}
        self._totals: Dict[str, float] = {}
        self._latencies: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._queue_waits: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._batch_sizes: Deque[Tuple[int, int]] = deque(maxlen=_LATENCY_WINDOW)
        self._completions: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._started = time.perf_counter()
        self._labels = {"service": name}
        reg = _obs.registry()
        self._lat_hist = reg.histogram(
            "serving_latency_seconds", labels=self._labels,
            help="end-to-end request latency")
        self._wait_hist = reg.histogram(
            "serving_queue_wait_seconds", labels=self._labels,
            help="time a request spent queued before execution")
        # sliding-window gauges (QPS, tail latencies) materialize lazily at
        # snapshot/scrape time; weakly referenced so a dead service drops out
        reg.add_collector(self._collect)

    # -- counters -----------------------------------------------------------------
    def _counter(self, name: str) -> _profiler.Counter:
        c = self._counters.get(name)
        if c is None:
            c = _profiler.Counter(self._domain, name)
            self._counters[name] = c
        return c

    def incr(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + delta
            self._counter(name).set_value(self._totals[name])
        _obs.registry().counter(f"serving_{name}",
                                labels=self._labels).inc(delta)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._totals[name] = value
            self._counter(name).set_value(value)
        _obs.registry().gauge(f"serving_{name}",
                              labels=self._labels).set(value)

    # -- observations -------------------------------------------------------------
    def observe_latency(self, seconds: float) -> None:
        now = time.perf_counter()
        with self._lock:
            self._latencies.append(seconds)
            self._completions.append(now)
            self._totals["requests_completed"] = \
                self._totals.get("requests_completed", 0) + 1
        self._lat_hist.observe(seconds)
        _obs.registry().counter("serving_requests_completed",
                                labels=self._labels).inc()

    def observe_queue_wait(self, seconds: float) -> None:
        with self._lock:
            self._queue_waits.append(seconds)
        self._wait_hist.observe(seconds)

    def observe_batch(self, real: int, padded: int) -> None:
        with self._lock:
            self._batch_sizes.append((int(real), int(padded)))
            self._totals["batches"] = self._totals.get("batches", 0) + 1
            self._counter("batches").set_value(self._totals["batches"])
        _obs.registry().counter("serving_batches", labels=self._labels).inc()

    # -- registry collector (sliding-window values as gauges) ---------------------
    def _collect(self) -> None:
        snap = self.snapshot()
        reg = _obs.registry()
        reg.gauge("serving_qps", labels=self._labels,
                  help="completions over the sliding QPS window"
                  ).set(snap["qps"])
        for q in ("p50", "p99"):
            v = snap["latency_ms"][q]
            if v is not None:
                reg.gauge("serving_latency_ms",
                          labels=dict(self._labels, quantile=q)).set(v)
        occ = snap.get("batch_occupancy")
        if occ is not None:
            reg.gauge("serving_batch_occupancy", labels=self._labels).set(occ)

    # -- snapshot -----------------------------------------------------------------
    def snapshot(self) -> dict:
        now = time.perf_counter()
        with self._lock:
            lat = list(self._latencies)
            waits = list(self._queue_waits)
            batches = list(self._batch_sizes)
            recent = [t for t in self._completions
                      if now - t <= _QPS_WINDOW_SEC]
            totals = dict(self._totals)
        out = dict(totals)
        out["latency_ms"] = {
            "p50": _ms(percentile(lat, 50)),
            "p90": _ms(percentile(lat, 90)),
            "p99": _ms(percentile(lat, 99)),
            "max": _ms(max(lat) if lat else None),
            "count": len(lat),
        }
        out["queue_wait_ms_p99"] = _ms(percentile(waits, 99))
        if batches:
            real = sum(r for r, _ in batches)
            padded = sum(p for _, p in batches)
            out["batch_occupancy"] = round(real / max(1, padded), 4)
            out["avg_batch_size"] = round(real / len(batches), 2)
        else:
            out["batch_occupancy"] = None
            out["avg_batch_size"] = None
        window = min(_QPS_WINDOW_SEC, max(now - self._started, 1e-9))
        out["qps"] = round(len(recent) / window, 2)
        out["uptime_sec"] = round(now - self._started, 3)
        return out


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)
