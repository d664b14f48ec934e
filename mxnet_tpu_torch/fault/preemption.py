"""Preemption handling: one process-wide SIGTERM/SIGINT hub.

PyTorch counterpart of ``mxnet_tpu/fault/preemption.py``.

A preemptible VM gets a SIGTERM and a short grace window; a Ctrl-C'd
training run gets SIGINT.  Python allows exactly one handler per signal
(and only from the main thread), but several subsystems legitimately want
the event — ``Module.fit`` (final synchronous checkpoint), serving
services (drain in-flight, reject queued).  This module multiplexes them:

- :func:`install_shutdown_hook` registers a callback; the FIRST
  registration installs the real handlers (main thread only — callers off
  the main thread get ``None`` back and must poll instead).  Callbacks run
  newest-first inside the signal handler; the previously-installed Python
  handler (if any) is chained after them.
- A SECOND delivery of the same signal restores the default disposition
  and re-raises — a stuck drain never blocks the kill.
- :class:`PreemptionHandler` is the polling-friendly wrapper ``fit`` uses:
  an event set by the signal (or by the ``TPUMX_FAULT_PREEMPT_AT_STEP``
  injection, which raises a REAL signal so the whole path is exercised).

Every delivery increments the ``preemption_signals_total{signal=...}``
registry counter.
"""
from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, List, Optional

__all__ = ["PreemptionHandler", "install_shutdown_hook",
           "signals_supported", "DEFAULT_SIGNALS"]

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def signals_supported() -> bool:
    """Whether this thread may install signal handlers (CPython: main
    thread of the main interpreter only)."""
    return threading.current_thread() is threading.main_thread()


class _SignalHub:
    """The single real handler per signal, dispatching registered callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[int], None]] = []
        self._prev: Dict[int, object] = {}
        self._fired: Dict[int, int] = {}

    def register(self, callback: Callable[[int], None],
                 signals=DEFAULT_SIGNALS) -> Optional[Callable[[], None]]:
        """Add ``callback(signum)``; returns an unregister fn, or None when
        handlers cannot be installed from this thread."""
        if not signals_supported():
            return None
        with self._lock:
            first = not self._callbacks
            self._callbacks.append(callback)
            if first or any(s not in self._prev for s in signals):
                for s in signals:
                    if s not in self._prev:
                        self._prev[s] = signal.signal(s, self._on_signal)

        def unregister():
            with self._lock:
                if callback in self._callbacks:
                    self._callbacks.remove(callback)
                if not self._callbacks:
                    self._restore_locked()

        return unregister

    def _restore_locked(self):
        if not signals_supported():
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev.clear()
        self._fired.clear()

    def _on_signal(self, signum, frame):
        from ..observability import flight_recorder as _flight
        from ..observability import registry as _registry

        try:
            _registry().counter(
                "preemption_signals_total",
                labels={"signal": signal.Signals(signum).name},
                help="SIGTERM/SIGINT deliveries observed by the fault "
                     "preemption hub").inc()
            # the black box sees every delivery, whether or not the
            # flight recorder's own dump hook is registered
            _flight.note("signal_delivery",
                         {"signal": signal.Signals(signum).name,
                          "count": self._fired.get(signum, 0) + 1})
        except Exception:
            pass
        with self._lock:
            self._fired[signum] = self._fired.get(signum, 0) + 1
            repeat = self._fired[signum] > 1
            callbacks = list(reversed(self._callbacks))
            prev = self._prev.get(signum)
        if repeat:
            # second delivery: the operator means it — default disposition
            with self._lock:
                self._restore_locked()
            signal.raise_signal(signum)
            return
        for cb in callbacks:
            try:
                cb(signum)
            except Exception:  # a broken subscriber must not mask the rest
                pass
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            try:
                prev(signum, frame)
            except Exception:
                pass


_hub = _SignalHub()


def install_shutdown_hook(callback: Callable[[int], None],
                          signals=DEFAULT_SIGNALS
                          ) -> Optional[Callable[[], None]]:
    """Run ``callback(signum)`` on SIGTERM/SIGINT (first delivery).  Returns
    the unregister function, or None off the main thread (poll instead)."""
    return _hub.register(callback, signals)


class PreemptionHandler:
    """``Module.fit``'s view: an event plus a per-step poll.

    ``install()`` registers with the hub (best-effort: off the main thread
    the event can still be set by :meth:`poll`'s fault injection).
    ``poll(global_step)`` additionally fires the
    ``TPUMX_FAULT_PREEMPT_AT_STEP`` injection by raising a REAL signal when
    possible, so the injected path and the production path are the same
    code.
    """

    def __init__(self, signals=DEFAULT_SIGNALS):
        self._signals = signals
        self._event = threading.Event()
        self._unregister: Optional[Callable[[], None]] = None

    def install(self) -> "PreemptionHandler":
        self._unregister = install_shutdown_hook(
            lambda signum: self._event.set(), self._signals)
        return self

    def uninstall(self) -> None:
        if self._unregister is not None:
            self._unregister()
            self._unregister = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        self._event.set()

    def poll(self, global_step: int) -> bool:
        """True when a preemption (real signal or injected) is pending."""
        if self._event.is_set():
            return True
        from .inject import injector

        if injector().preempt_due(global_step):
            if self._unregister is not None and signals_supported():
                # deliver a real SIGTERM so the full handler path runs
                signal.raise_signal(signal.SIGTERM)
            else:
                self._event.set()
        return self._event.is_set()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
