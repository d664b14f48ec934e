"""Crash flight recorder: postmortems start from data, not logs.

PyTorch counterpart of ``mxnet_tpu/observability/flight_recorder.py``.

A process-wide bounded ring of noteworthy runtime moments (quarantines,
breaker transitions, periodic metric deltas, signal deliveries) that —
together with the tracing layer's span and wide-event rings and a full
metrics snapshot — dumps to ONE timestamped JSON file when something dies:

- ``dump(reason)`` — the explicit spelling; returns the file path;
- :class:`GenerationService` dumps on a ``GenerationStepError``
  quarantine (the failing request's wide event rides in ``extra``);
- :class:`~mxnet_tpu_torch.serving.router.GenerationRouter` dumps when a
  replica's circuit breaker opens;
- :func:`install` hooks SIGTERM/SIGINT (via the
  :mod:`mxnet_tpu_torch.fault.preemption` hub) and ``sys.excepthook`` so a dying
  process leaves its last seconds behind — the serving services and the
  router install it alongside their signal handlers.

``TPUMX_FLIGHT_RECORDER=0`` disables every dump; files land in
``TPUMX_FLIGHT_RECORDER_DIR`` (default: the system temp dir) as
``tpumx_flight_<utc timestamp>_<reason>_<pid>.json``.  Each dump also
increments ``flight_recorder_dumps_total{reason}`` and remembers its path
(:func:`last_dump`).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..base import getenv

__all__ = ["note", "dump", "last_dump", "install", "uninstall", "enabled",
           "recent_notes", "clear"]

_lock = threading.Lock()
# guards _notes: deque appends are atomic, but list(_notes) raises
# RuntimeError if an engine thread appends mid-iteration
_notes_lock = threading.Lock()
_notes: "deque[dict]" = deque(
    maxlen=int(getenv("TPUMX_FLIGHT_RECORDER_EVENTS", 1024)))
_last_dump_path: Optional[str] = None
_seq = [0]
_install_lock = threading.Lock()
_install_count = 0
_signal_unregister: Optional[Callable[[], None]] = None
_prev_excepthook = None


def enabled() -> bool:
    """Whether dumps fire (``TPUMX_FLIGHT_RECORDER``, default 1); read
    live so tests can flip it per case."""
    v = os.environ.get("TPUMX_FLIGHT_RECORDER")
    return v is None or v.strip().lower() not in ("0", "false", "off", "no")


def _directory() -> str:
    return os.environ.get("TPUMX_FLIGHT_RECORDER_DIR") or tempfile.gettempdir()


def note(kind: str, data: Optional[dict] = None) -> None:
    """Append one moment to the bounded ring (cheap; rides in every later
    dump).  The engine notes periodic metric deltas here, the router notes
    breaker transitions, the preemption hub's hook notes signals."""
    with _notes_lock:
        _notes.append({"t": time.time(), "kind": kind, "data": data or {}})


def recent_notes() -> list:
    with _notes_lock:
        return list(_notes)


def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write the black box: recent notes + span ring + wide-event ring +
    a full metrics snapshot, as one JSON file.  Returns the path (None
    when disabled or anything fails — NEVER raises: a dying process must
    not die harder because its postmortem failed, and callers on failover
    paths (breaker-open, quarantine) must not be derailed by it)."""
    global _last_dump_path
    try:
        if not enabled():
            return None
        from . import registry as _registry
        from . import tracing as _tracing

        try:
            metrics = _registry().snapshot()
        except Exception:
            metrics = {"error": "metrics snapshot failed"}
        payload = {
            "reason": reason,
            "time_unix": time.time(),
            "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "extra": extra or {},
            "notes": recent_notes(),
            "wide_events": _tracing.recent_requests(),
            "spans": _tracing.recent_spans(),
            "metrics": metrics,
        }
        with _lock:
            _seq[0] += 1
            path = os.path.join(
                _directory(),
                f"tpumx_flight_"
                f"{time.strftime('%Y%m%d-%H%M%S', time.gmtime())}"
                f"_{reason}_{os.getpid()}_{_seq[0]}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)  # readers never see a torn dump
            _last_dump_path = path
    except Exception:
        return None
    try:
        _registry().counter(
            "flight_recorder_dumps_total", labels={"reason": reason},
            help="flight-recorder postmortem dumps written").inc()
    except Exception:
        pass
    return path


def last_dump() -> Optional[str]:
    """Path of the most recent dump this process wrote, or None."""
    return _last_dump_path


def install() -> None:
    """Hook SIGTERM/SIGINT (preemption hub; no-op off the main thread) and
    ``sys.excepthook`` so crashes and preemptions dump automatically.
    Refcounted: a router plus a standalone service (or several services)
    each install alongside their signal handlers, and the process-global
    hooks stay armed until the LAST owner uninstalls."""
    global _install_count, _signal_unregister, _prev_excepthook
    with _install_lock:
        _install_count += 1
        if not enabled():
            return
        if _signal_unregister is None:
            from ..fault.preemption import install_shutdown_hook

            def _on_signal(signum):
                note("signal", {"signum": int(signum)})
                dump(f"signal_{int(signum)}")

            _signal_unregister = install_shutdown_hook(_on_signal)
        if _prev_excepthook is None:
            prev = sys.excepthook

            def _hook(exc_type, exc, tb):
                try:
                    dump("crash", extra={"exception": repr(exc),
                                         "type": exc_type.__name__})
                except Exception:
                    pass
                prev(exc_type, exc, tb)

            _prev_excepthook = prev
            sys.excepthook = _hook


def uninstall() -> None:
    """Drop one :func:`install` reference; the crash/SIGTERM dump hooks
    are only restored once the count reaches zero, so the first component
    to tear down its signal handlers cannot silently disarm the black box
    for every still-running component."""
    global _install_count, _signal_unregister, _prev_excepthook
    with _install_lock:
        if _install_count > 0:
            _install_count -= 1
        if _install_count > 0:
            return
        if _signal_unregister is not None:
            _signal_unregister()
            _signal_unregister = None
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None


def clear() -> None:
    """Drop the note ring and forget the last dump path (tests)."""
    global _last_dump_path
    with _notes_lock:
        _notes.clear()
    _last_dump_path = None
