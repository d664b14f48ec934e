"""mxnet_tpu_torch.observability — the runtime observability subsystem.

PyTorch counterpart of ``mxnet_tpu.observability``:

- :mod:`.metrics` — a process-wide, thread-safe labeled metrics registry
  (Counter/Gauge/Histogram with fixed buckets + reservoir percentiles),
  JSON :func:`snapshot` and Prometheus text exposition
  (:func:`to_prometheus`, :func:`dump_prometheus`, :mod:`.exposition`
  HTTP endpoint);
- :mod:`.tracing` — nested :class:`span`s that emit into the profiler's
  chrome-trace stream (and ``torch.profiler.record_function`` ranges while
  it runs), the trace-context layer (``TraceContext`` ids propagated
  thread-locally and handed off explicitly across queue/thread/replica
  boundaries) and the per-request wide-event records behind
  :func:`recent_requests`;
- :mod:`.flight_recorder` — the crash black box: bounded rings of recent
  spans, wide events and notes that dump to a timestamped JSON file on a
  crash, SIGTERM, a decode-step quarantine or a circuit breaker opening;
- :mod:`.recompile` — the program-cache explainer and watchdog
  (``TPUMX_EXPLAIN_RECOMPILES=1`` logs miss causes;
  ``TPUMX_FREEZE_COMPILES=1`` + :func:`mark_warm` makes any post-warmup
  miss raise).  In the port a miss is a new program key, a new CUDA graph
  capture or a new serving executor bind;
- :mod:`.telemetry` — the gradient and parameter norms, step loss, loss
  scale and non-finite/skip counts computed on the device after each fused
  train step and read on the host only every ``TPUMX_TELEMETRY_EVERY``
  steps (``TPUMX_TELEMETRY=0`` turns it off).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS)
from .tracing import (span, current_span, span_stack, TraceContext,
                      new_trace, current_trace, use_context,
                      recent_requests, recent_spans)
from .recompile import (FreezeCompilesError, explain_key_diff,
                        last_explanations, mark_warm)
from . import exposition
from . import flight_recorder
from . import metrics
from . import recompile
from . import telemetry
from . import tracing

__all__ = ["registry", "snapshot", "to_prometheus", "dump_prometheus",
           "reset", "span", "current_span", "span_stack", "mark_warm",
           "TraceContext", "new_trace", "current_trace", "use_context",
           "recent_requests", "recent_spans",
           "last_explanations", "explain_key_diff", "FreezeCompilesError",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "metrics", "tracing", "recompile",
           "telemetry", "exposition", "flight_recorder"]

#: the process-wide default registry every subsystem records into
_default_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default :class:`MetricsRegistry`."""
    return _default_registry


def snapshot() -> dict:
    """One JSON-safe dict of every metric in the default registry."""
    return _default_registry.snapshot()


def to_prometheus() -> str:
    """Prometheus text exposition (format 0.0.4) of the default registry."""
    return _default_registry.to_prometheus()


def dump_prometheus(path: str) -> None:
    """Write the default registry's exposition text to ``path``."""
    _default_registry.dump_prometheus(path)


def reset() -> None:
    """Clear the default registry AND the recompile explainer state
    (test isolation).  Trace/wide-event rings and the flight
    recorder's note ring have their own ``clear()``s — a metrics reset
    must not erase the black box a postmortem is about to dump."""
    _default_registry.reset()
    recompile.reset()
