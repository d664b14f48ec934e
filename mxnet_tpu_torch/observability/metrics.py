"""Labeled metrics registry: Counter / Gauge / Histogram with JSON snapshot
and Prometheus text exposition.

PyTorch counterpart of ``mxnet_tpu/observability/metrics.py``: the
process-wide registry the generation engine, the router and the program
cache's recompile counters record into, so a single ``snapshot()`` (or a
Prometheus scrape) answers "is this run healthy" without grepping logs.

Design:

- a metric *family* is (name, type, help); *children* are label-set
  instances of the family (``requests_total{service="lm"}``) — the
  Prometheus data model, kept dependency-free;
- counters and gauges are plain floats guarded by the registry lock (the
  read-modify-write is atomic);
- histograms keep fixed cumulative buckets (exposition) plus a reservoir
  sample (percentiles in ``snapshot()``) — bounded memory however long the
  process lives;
- ``add_collector`` registers pull-style callbacks (e.g. serving QPS over a
  sliding window) run at snapshot/exposition time, weakly referenced so a
  dead subsystem never pins itself in the registry.
"""
from __future__ import annotations

import json
import math
import random
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

#: default histogram buckets (seconds-flavored: 1ms .. 10s), cumulative ``le``
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_RESERVOIR_SIZE = 1024


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    esc = lambda v: v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


def _format_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter child (one label set of a family)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous-value child."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed cumulative buckets (Prometheus exposition) + a uniform
    reservoir sample (percentiles) — bounded memory at any observation
    count."""

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._count = 0
        self._sum = 0.0
        self._max = None
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5EED)  # deterministic sampling for tests

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if self._max is None or value > self._max:
                self._max = value
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            self._bucket_counts[i] += 1
            if len(self._reservoir) < _RESERVOIR_SIZE:
                self._reservoir.append(value)
            else:  # uniform reservoir sampling over the full stream
                j = self._rng.randrange(self._count)
                if j < _RESERVOIR_SIZE:
                    self._reservoir[j] = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile (q in [0, 100]) over the reservoir."""
        with self._lock:
            xs = sorted(self._reservoir)
        if not xs:
            return None
        rank = max(0, min(len(xs) - 1,
                          int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[rank]

    def _stats(self) -> dict:
        with self._lock:
            xs = sorted(self._reservoir)
            count, total, mx = self._count, self._sum, self._max
        pick = lambda q: (xs[max(0, min(len(xs) - 1,
                                        int(round(q / 100.0 * (len(xs) - 1)))))]
                          if xs else None)
        return {"count": count, "sum": total, "max": mx,
                "p50": pick(50), "p90": pick(90), "p99": pick(99)}

    def _cumulative_buckets(self) -> List[Tuple[float, int]]:
        with self._lock:
            counts = list(self._bucket_counts)
        out, running = [], 0
        for le, c in zip(self.buckets + (math.inf,), counts):
            running += c
            out.append((le, running))
        return out


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``counter/gauge/histogram`` get-or-create the family and return the
    child for the given label set — repeated calls are cheap lookups, so
    hot paths can call them inline.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (type, help, buckets|None, {label_key: child})
        self._families: Dict[str, tuple] = {}
        self._collectors: List[object] = []

    # -- family accessors ---------------------------------------------------------
    def _child(self, name: str, typ: str, labels: Optional[dict],
               help: Optional[str], buckets: Optional[Sequence[float]]):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (typ, help or "", tuple(buckets) if buckets else None, {})
                self._families[name] = fam
            elif fam[0] != typ:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"not {typ}")
            children = fam[3]
            child = children.get(key)
            if child is None:
                lock = threading.Lock()
                if typ == "counter":
                    child = Counter(lock)
                elif typ == "gauge":
                    child = Gauge(lock)
                else:
                    child = Histogram(lock, fam[2] or DEFAULT_BUCKETS)
                children[key] = child
            return child

    def counter(self, name: str, labels: Optional[dict] = None,
                help: Optional[str] = None) -> Counter:
        return self._child(name, "counter", labels, help, None)

    def gauge(self, name: str, labels: Optional[dict] = None,
              help: Optional[str] = None) -> Gauge:
        return self._child(name, "gauge", labels, help, None)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  help: Optional[str] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._child(name, "histogram", labels, help, buckets)

    # -- pull-style collectors ----------------------------------------------------
    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback run before every snapshot/exposition (e.g.
        sliding-window QPS).  Bound methods are held weakly: a collected
        subsystem that dies simply stops contributing."""
        ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") else fn
        with self._lock:
            self._collectors.append(ref)

    def _run_collectors(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        dead = []
        for ref in refs:
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(ref)
                continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — a broken collector must not
                # take down every scrape: the rest of the snapshot still
                # serves, and the failure is itself a metric
                try:
                    self.counter(
                        "observability_collector_errors_total",
                        labels={"collector": getattr(
                            fn, "__qualname__", None) or repr(fn)},
                        help="pull collectors that raised during a "
                             "snapshot/scrape (isolated per collector)"
                    ).inc()
                except Exception:
                    pass
        if dead:
            with self._lock:
                self._collectors = [r for r in self._collectors
                                    if r not in dead]

    # -- output -------------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-safe dict of everything: counters/gauges as flat values,
        histograms as {count, sum, max, p50, p90, p99}."""
        self._run_collectors()
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            families = {n: (f[0], dict(f[3])) for n, f in
                        self._families.items()}
        for name in sorted(families):
            typ, children = families[name]
            for key in sorted(children):
                child = children[key]
                full = name + _format_labels(key)
                if typ == "counter":
                    out["counters"][full] = child.value
                elif typ == "gauge":
                    out["gauges"][full] = child.value
                else:
                    out["histograms"][full] = child._stats()
        return out

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._run_collectors()
        with self._lock:
            families = {n: (f[0], f[1], dict(f[3]))
                        for n, f in self._families.items()}
        lines: List[str] = []
        for name in sorted(families):
            typ, help_, children = families[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            for key in sorted(children):
                child = children[key]
                label_str = _format_labels(key)
                if typ in ("counter", "gauge"):
                    lines.append(
                        f"{name}{label_str} {_format_value(child.value)}")
                    continue
                for le, cum in child._cumulative_buckets():
                    ble = "+Inf" if math.isinf(le) else _format_value(le)
                    bkey = key + (("le", ble),)
                    lines.append(f"{name}_bucket{_format_labels(bkey)} {cum}")
                lines.append(f"{name}_sum{label_str} "
                             f"{_format_value(child.sum)}")
                lines.append(f"{name}_count{label_str} {child.count}")
        return "\n".join(lines) + "\n"

    def dump_prometheus(self, path: str) -> None:
        """Write the exposition text to ``path`` (node-exporter textfile
        collector convention — scrape without running an HTTP endpoint)."""
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def reset(self) -> None:
        """Drop every family and collector (tests)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()
