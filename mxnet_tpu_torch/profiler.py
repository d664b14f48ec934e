"""Profiler: host-side events in chrome://tracing format, aggregate
summaries, domains, counters, markers and ``scope``.

PyTorch counterpart of ``mxnet_tpu/profiler.py`` (MXNet's
``python/mxnet/profiler.py``).  The events are recorded on the host only;
device kernels are traced with ``torch.profiler`` (which the reference's
``jax.profiler`` hook corresponds to) and are not driven from here.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List

__all__ = ["set_config", "set_state", "profiler_set_config", "profiler_set_state",
           "start", "stop", "pause", "resume", "dump", "dumps", "Task", "Frame",
           "Event", "Counter", "Marker", "Domain", "scope"]

_lock = threading.Lock()
_events: List[dict] = []
_state = {"running": False, "filename": "profile.json", "aggregate": False,
          "t0": None}
_counters: Dict[str, float] = {}


def set_config(filename="profile.json", profile_all=False, profile_symbolic=False,
               profile_imperative=False, profile_memory=False, profile_api=False,
               aggregate_stats=False, continuous_dump=False, **kwargs):
    """Reference: MXSetProcessProfilerConfig.

    All category flags persist (an earlier version silently dropped
    ``profile_memory``/``profile_api``/``continuous_dump``): the memory and
    api flags gate their event categories in :func:`_emit`, and
    ``continuous_dump`` makes :func:`stop` flush the trace to ``filename``
    automatically (the reference's keep-dumping-without-MXDumpProfile mode).
    """
    _state["filename"] = filename
    _state["aggregate"] = aggregate_stats
    _state["imperative"] = bool(profile_imperative or profile_all)
    _state["symbolic"] = bool(profile_symbolic or profile_all)
    _state["memory"] = bool(profile_memory or profile_all)
    _state["api"] = bool(profile_api or profile_all)
    _state["continuous_dump"] = bool(continuous_dump)


profiler_set_config = set_config


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


profiler_set_state = set_state


def start(profile_process="worker"):
    """Start recording (idempotent, like the reference)."""
    _state["running"] = True
    _state["t0"] = time.perf_counter()


def stop(profile_process="worker"):
    _state["running"] = False
    if _state.get("continuous_dump"):
        dump()


def pause(profile_process="worker"):
    _state["running"] = False


def resume(profile_process="worker"):
    _state["running"] = True


def _op_profiling() -> bool:
    """True when per-op imperative profiling is active."""
    return _state["running"] and _state.get("imperative", False)


# event categories gated by their set_config flag; anything else (counters,
# python scopes, serving spans) records whenever the profiler runs
_GATED_CATS = {"memory": "memory", "api": "api"}


def _emit(ph, name, cat, ts=None, dur=None, args=None, force=False):
    if not _state["running"] and not force:
        return
    flag = _GATED_CATS.get(cat)
    if flag is not None and not _state.get(flag, False):
        return
    ev = {"ph": ph, "name": name, "cat": cat, "pid": os.getpid(),
          "tid": threading.get_ident(),
          "ts": (ts if ts is not None else time.perf_counter() * 1e6)}
    if dur is not None:
        ev["dur"] = dur
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def dumps(reset=False, format="table"):
    """Aggregate summary string (reference: MXAggregateProfileStatsPrint);
    format="json" returns the chrome://tracing event JSON instead."""
    if format == "json":
        with _lock:
            out = json.dumps({"traceEvents": list(_events),
                              "displayTimeUnit": "ms"})
            if reset:
                _events.clear()
        return out
    agg = defaultdict(lambda: [0, 0.0])
    with _lock:
        for ev in _events:
            if ev["ph"] == "X":
                agg[ev["name"]][0] += 1
                agg[ev["name"]][1] += ev.get("dur", 0.0)
    lines = [f"{'Name':<40}{'Count':>10}{'Total(us)':>15}"]
    for name, (cnt, total) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<40}{cnt:>10}{total:>15.1f}")
    if reset:
        with _lock:
            _events.clear()
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write chrome://tracing JSON (reference: MXDumpProfile)."""
    with _lock:
        data = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(_state["filename"], "w") as f:
        json.dump(data, f)


class Domain:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"Domain({self.name})"


class Task:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter() * 1e6

    def stop(self):
        if self._t0 is not None:
            _emit("X", self.name, self.domain.name, ts=self._t0,
                  dur=time.perf_counter() * 1e6 - self._t0)
            self._t0 = None  # a second stop() must not emit a phantom span


Frame = Task


class Event(Task):
    pass


class Counter:
    def __init__(self, domain, name, value=0):
        self.domain = domain
        self.name = name
        self._value = value
        # per-counter lock: increment/decrement are read-modify-write and
        # raced from multiple threads (serving worker + submitters); the
        # unguarded `self._value + delta` lost updates
        self._vlock = threading.Lock()

    def set_value(self, value):
        with self._vlock:
            self._value = value
        _emit("C", self.name, self.domain.name, args={self.name: value})

    def increment(self, delta=1):
        with self._vlock:
            self._value += delta
            value = self._value
        _emit("C", self.name, self.domain.name, args={self.name: value})

    def decrement(self, delta=1):
        self.increment(-delta)

    __iadd__ = lambda self, d: (self.increment(d), self)[1]
    __isub__ = lambda self, d: (self.decrement(d), self)[1]


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        _emit("i", self.name, self.domain.name, args={"scope": scope})


class scope:
    """Context manager timing a region as one trace slice."""

    def __init__(self, name, cat="python"):
        self._name = name
        self._cat = cat

    def __enter__(self):
        self._t0 = time.perf_counter() * 1e6
        self._active = _state["running"]  # capture at entry: a span that ran
        return self                        # under a live profiler is recorded
                                           # even if stop() lands inside it

    def __exit__(self, *exc):
        # the captured entry state decides BOTH ways: a span entered under a
        # live profiler is recorded even if stop() landed inside it
        # (force=True, never a flip of the shared running flag, which would
        # race other threads' emits past stop()); one entered while the
        # profiler was stopped stays unrecorded even if start() landed
        # before exit — its t0 predates the trace and would emit a phantom
        # pre-start() slice
        if self._active:
            _emit("X", self._name, self._cat, ts=self._t0,
                  dur=time.perf_counter() * 1e6 - self._t0, force=True)
