"""Structured tracing: trace contexts, nested spans, and wide-event records.

PyTorch counterpart of ``mxnet_tpu/observability/tracing.py``.  Three
layers, cheapest first:

1. **Spans** (:class:`span`) — nested context managers that emit

   - a chrome://tracing complete event into
     :mod:`mxnet_tpu_torch.profiler`'s event stream, and
   - while that profiler runs, a ``torch.profiler.record_function`` range
     around the region, so under ``torch.profiler`` the host span shows up
     on the same timeline as the CUDA kernels it launched.

2. **Trace contexts** (:class:`TraceContext`) — Dapper-style per-request
   ids.  A context is ``(trace_id, span_id)``; it propagates thread-locally
   (every span opened under it becomes a child and narrows the context to
   itself), and crosses queue/thread boundaries by EXPLICIT handoff: the
   submitting side captures :func:`current_trace` (or mints
   :func:`new_trace`), parks it on the queued work item, and the worker
   re-activates it with :func:`use_context` / :func:`attach`.  Every span
   that runs under a context lands in a process-wide bounded ring
   (:func:`recent_spans`) with its trace/span/parent ids — the same ids
   ride the chrome-trace event ``args``, so one perfetto timeline shows a
   request hopping threads and replicas.  Orca-style shared work (one
   decode step serving many requests) stays attributable through
   :func:`record_event`: the shared step emits one span per *participating*
   request's trace, covering the step's interval.

3. **Wide events** (:func:`record_wide_event`) — one structured record per
   finished request (id, priority, token counts, TTFT breakdown, replica,
   outcome) into a bounded ring
   (:func:`recent_requests`) plus an optional append-only JSONL sink
   (``TPUMX_TRACE_LOG``).

``TPUMX_TRACING=0`` disables layers 2–3 (no contexts, no rings, no sink);
span timing/profiler behavior — and everything the engine computes — stays
the same.  With tracing on and the profiler stopped a span is two
``time.perf_counter`` calls, a list push/pop and one deque append.

Whether a span emits a *profiler* event is captured at entry (same rule as
``profiler.scope``): a span that started under a stopped profiler emits
nothing even if ``start()`` lands before it exits, and one that started
under a running profiler is recorded even if ``stop()`` lands inside it.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Iterable, List, Optional

from .. import profiler as _profiler
from ..base import getenv

__all__ = ["span", "current_span", "span_stack", "TraceContext",
           "new_trace", "current_trace", "use_context", "attach", "detach",
           "enabled", "record_event", "record_wide_event", "recent_spans",
           "recent_requests", "clear"]

_tls = threading.local()

#: bounded rings behind recent_spans()/recent_requests() — also the flight
#: recorder's raw material.  _ring_lock is shared
#: by appenders and snapshot readers: deque appends are atomic, but
#: list(ring) raises RuntimeError when an engine thread appends
#: mid-iteration, which would poison stats/debug callers and dump()
_ring_lock = threading.Lock()
_SPAN_RING: "deque[dict]" = deque(
    maxlen=int(getenv("TPUMX_TRACE_BUFFER", 4096)))
_WIDE_RING: "deque[dict]" = deque(
    maxlen=int(getenv("TPUMX_TRACE_REQUESTS", 1024)))
_sink_lock = threading.Lock()
_span_ids = itertools.count(1)  # next() is GIL-atomic


def enabled() -> bool:
    """Whether the trace-context layer is on (``TPUMX_TRACING``, default 1).
    Read live so tests can flip it per case."""
    v = os.environ.get("TPUMX_TRACING")
    return v is None or v.strip().lower() not in ("0", "false", "off", "no")


class TraceContext:
    """One request's position in its trace: ``trace_id`` names the whole
    request, ``span_id`` the innermost open span (the parent of whatever
    is recorded under this context)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id}, {self.span_id})"


def _next_span_id() -> str:
    return f"s{next(_span_ids):x}"


def new_trace() -> Optional[TraceContext]:
    """Mint a fresh root context (None when tracing is disabled)."""
    if not enabled():
        return None
    return TraceContext(uuid.uuid4().hex[:16], _next_span_id())


def current_trace() -> Optional[TraceContext]:
    """The calling thread's active context, or None."""
    return getattr(_tls, "ctx", None)


def attach(ctx: Optional[TraceContext]):
    """Activate ``ctx`` on this thread; returns a token for :func:`detach`.
    ``None`` is a no-op (the pattern for gated callers)."""
    prev = getattr(_tls, "ctx", None)
    if ctx is not None:
        _tls.ctx = ctx
    return (ctx is not None, prev)


def detach(token) -> None:
    if token is not None and token[0]:
        _tls.ctx = token[1]


class use_context:
    """``with use_context(ctx):`` — the explicit cross-thread handoff.
    A ``None`` ctx is a no-op, so callers never branch on the gate."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._token = attach(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        detach(self._token)
        return False


def span_stack():
    """The calling thread's open-span name stack (outermost first)."""
    return list(getattr(_tls, "stack", ()))


def current_span() -> Optional[str]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _ring_append(name, cat, trace_id, span_id, parent_id, ts, dur, args,
                 thread=None):
    with _ring_lock:
        _SPAN_RING.append({
            "name": name, "cat": cat, "trace_id": trace_id,
            "span_id": span_id, "parent_id": parent_id, "ts_us": ts,
            "dur_us": dur,
            "thread": thread if thread is not None
            else threading.get_ident(),
            "args": args or {},
        })


class span:
    """``with span("serving.execute", cat="serving", args={...}):`` — one
    nested slice in the unified timeline.

    Under an active :class:`TraceContext` (inherited thread-locally, or
    forced with ``ctx=``) the span gets a span id, parents onto the
    context, narrows the context to itself for the body, and lands in the
    trace ring with its ids on exit."""

    __slots__ = ("name", "cat", "args", "_t0", "_active", "_range",
                 "_ctx_in", "_span_id", "_trace_id", "_parent_id",
                 "_ctx_token", "_traced")

    def __init__(self, name: str, cat: str = "obs", args: Optional[dict]
                 = None, ctx: Optional[TraceContext] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._ctx_in = ctx

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        # capture at entry; honored both ways at exit (profiler.scope fix)
        self._active = _profiler._state["running"]
        self._range = None
        if self._active:
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        parent = stack[-1] if stack else None
        stack.append(self.name)
        if self._active and parent is not None:
            self.args = dict(self.args or ())
            self.args.setdefault("parent", parent)
        # trace-context plumbing (captured at entry, like _active)
        self._traced = enabled()
        self._span_id = self._trace_id = self._parent_id = None
        self._ctx_token = None
        if self._traced:
            ctx = self._ctx_in if self._ctx_in is not None \
                else getattr(_tls, "ctx", None)
            if ctx is not None:
                self._span_id = _next_span_id()
                self._trace_id = ctx.trace_id
                self._parent_id = ctx.span_id
                self._ctx_token = attach(
                    TraceContext(ctx.trace_id, self._span_id))
        self._t0 = time.perf_counter() * 1e6
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter() * 1e6
        stack = getattr(_tls, "stack", None)
        if stack:
            stack.pop()
        detach(self._ctx_token)
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._traced:
            if self._span_id is not None:
                self.args = dict(self.args or ())
                self.args["trace_id"] = self._trace_id
                self.args["span_id"] = self._span_id
                self.args["parent_span_id"] = self._parent_id
            _ring_append(self.name, self.cat, self._trace_id, self._span_id,
                         self._parent_id, self._t0, t1 - self._t0, self.args)
        # force=True (never a flip of the shared running flag) records a
        # span that was entered under a live profiler even if stop() landed
        # inside it; one entered while stopped stays unrecorded either way
        if self._active:
            _profiler._emit("X", self.name, self.cat, ts=self._t0,
                            dur=t1 - self._t0, args=self.args, force=True)
        return False


def record_event(name: str, cat: str, t0: float, t1: float,
                 ctx: Optional[TraceContext] = None,
                 args: Optional[dict] = None) -> Optional[str]:
    """Record a completed interval ``[t0, t1]`` (perf_counter seconds) as a
    span of ``ctx``'s trace — the Orca-attribution primitive: a SHARED step
    (one decode program serving many requests) calls this once per
    participating request, so each trace shows its own participation slice
    without the step running once per request.  Returns the span id."""
    if not enabled():
        return None
    sid = _next_span_id()
    trace_id = parent_id = None
    if ctx is not None:
        trace_id, parent_id = ctx.trace_id, ctx.span_id
    with _ring_lock:
        _SPAN_RING.append({
            "name": name, "cat": cat, "trace_id": trace_id, "span_id": sid,
            "parent_id": parent_id, "ts_us": t0 * 1e6,
            "dur_us": (t1 - t0) * 1e6,
            "thread": threading.get_ident(), "args": args or {},
        })
    if _profiler._state["running"]:  # keep the no-profiler hot path lean
        args = dict(args or ())
        if ctx is not None:
            args["trace_id"] = trace_id
            args["span_id"] = sid
            args["parent_span_id"] = parent_id
        _profiler._emit("X", name, cat, ts=t0 * 1e6, dur=(t1 - t0) * 1e6,
                        args=args)
    return sid


def record_wide_event(event: dict) -> None:
    """Record one request-terminating wide event: ring + optional JSONL
    sink (``TPUMX_TRACE_LOG``) + a chrome-trace instant event when the
    profiler runs.  The event dict is stored as given."""
    if not enabled():
        return
    with _ring_lock:
        _WIDE_RING.append(event)
    _profiler._emit("i", "request.complete", "trace",
                    args={"wide_event": event})
    path = os.environ.get("TPUMX_TRACE_LOG")
    if path:
        try:
            line = json.dumps(event, default=str)
            with _sink_lock:
                with open(path, "a") as f:
                    f.write(line + "\n")
        except OSError:
            pass  # a broken sink must not take down serving


def recent_spans(trace_id: Optional[str] = None,
                 name: Optional[str] = None,
                 limit: Optional[int] = None) -> List[dict]:
    """Recent span records (oldest first), optionally filtered by trace id
    and/or span name."""
    with _ring_lock:
        out: Iterable[dict] = list(_SPAN_RING)
    if trace_id is not None:
        out = [s for s in out if s["trace_id"] == trace_id]
    if name is not None:
        out = [s for s in out if s["name"] == name]
    out = list(out)
    return out[-limit:] if limit else out


def recent_requests(trace_id: Optional[str] = None,
                    limit: Optional[int] = None) -> List[dict]:
    """Recent wide-event records (oldest first) — one per finished
    request; ``observability.recent_requests()`` re-exports this."""
    with _ring_lock:
        out = list(_WIDE_RING)
    if trace_id is not None:
        out = [e for e in out if e.get("trace_id") == trace_id]
    return out[-limit:] if limit else out


def clear() -> None:
    """Drop the span and wide-event rings (test isolation)."""
    with _ring_lock:
        _SPAN_RING.clear()
        _WIDE_RING.clear()
