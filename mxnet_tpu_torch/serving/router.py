"""Multi-replica generation routing: the serving fleet.

PyTorch counterpart of ``mxnet_tpu/serving/router.py``.
``GenerationRouter`` puts N :class:`~mxnet_tpu_torch.serving.generation.
GenerationService` replicas behind one front-end (on one card the
replicas share it, each with its own KV pool):

- **least-loaded dispatch** — each submit picks the healthy replica with
  the lowest load score (queue depth + running slots + KV occupancy, the
  same signals the observability gauges export), under a
  ``router.dispatch`` span;
- **health probes + circuit breaker** — a background probe loop polls
  every replica's :meth:`~GenerationService.health`; consecutive probe
  failures (a dead engine loop, a killed replica) or a decode-step
  failure streak open the replica's breaker (no new traffic), a cooldown
  later it goes half-open and a passing probe closes it again;
- **failure isolation / resubmission** — when a replica is declared
  dead, every request it accepted but never started streaming is
  resubmitted to a healthy replica with no client-visible error (tokens
  are keyed on (seed, position), so the regenerated stream is
  bit-identical); requests that were already mid-stream fail with a
  typed :class:`ReplicaDeadError`;
- **drain-aware shutdown** — :meth:`shutdown` drains running work and
  rejects queued requests on every replica, and
  :meth:`install_signal_handlers` wires that to the SIGTERM/SIGINT hub
  in :mod:`mxnet_tpu_torch.fault.preemption`, exactly like the
  single-replica services.

``TPUMX_FAULT_GEN_KILL_REPLICA=N[@K]`` kills
replica ``N`` right after its ``K``-th dispatch, driving the whole
detect → break → resubmit path deterministically in tests.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as _np

from .. import observability as _obs
from ..base import getenv
from ..fault.inject import injector as _fault_injector
from ..observability import flight_recorder as _flight
from ..observability import tracing as _trace
from .batcher import ServingClosedError, ServingError
from .generation import GenerationConfig, GenerationService

__all__ = ["GenerationRouter", "RouterConfig", "RouterStream",
           "ReplicaDeadError", "NoHealthyReplicaError"]

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class ReplicaDeadError(ServingError):
    """The replica serving this request died after the stream had already
    started — the router cannot transparently resubmit it without risking
    duplicate token delivery, so the client gets this typed error."""


class NoHealthyReplicaError(ServingError):
    """Every replica's circuit breaker is open (or dead) — nothing can
    take the dispatch."""


class RouterConfig:
    """Knobs for :class:`GenerationRouter`; defaults read their
    ``TPUMX_ROUTER_*`` environment variables."""

    def __init__(self, num_replicas: Optional[int] = None,
                 probe_interval_ms: Optional[float] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None,
                 affinity: Optional[bool] = None,
                 affinity_blocks: Optional[int] = None):
        self.num_replicas = int(num_replicas if num_replicas is not None
                                else getenv("TPUMX_ROUTER_REPLICAS", 2))
        if self.num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.probe_interval_ms = float(
            probe_interval_ms if probe_interval_ms is not None
            else getenv("TPUMX_ROUTER_PROBE_MS", 20.0))
        if self.probe_interval_ms <= 0:
            raise ValueError("probe_interval_ms must be > 0")
        self.breaker_failures = int(
            breaker_failures if breaker_failures is not None
            else getenv("TPUMX_ROUTER_BREAKER_FAILURES", 3))
        if self.breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1")
        self.breaker_cooldown_ms = float(
            breaker_cooldown_ms if breaker_cooldown_ms is not None
            else getenv("TPUMX_ROUTER_BREAKER_COOLDOWN_MS", 500.0))
        # shared-prefix affinity:
        # dispatch hashes the leading prompt blocks and prefers the
        # replica that last served that prefix, turning per-replica
        # prefix caches into a fleet-wide one.  Breaker/health gating is
        # unchanged — affinity only picks AMONG eligible replicas.
        self.affinity = bool(affinity if affinity is not None
                             else getenv("TPUMX_ROUTER_AFFINITY", True))
        self.affinity_blocks = int(
            affinity_blocks if affinity_blocks is not None
            else getenv("TPUMX_ROUTER_AFFINITY_BLOCKS", 4))
        if self.affinity_blocks < 1:
            raise ValueError("affinity_blocks must be >= 1")

    def __repr__(self):
        return (f"RouterConfig(num_replicas={self.num_replicas}, "
                f"probe_interval_ms={self.probe_interval_ms}, "
                f"breaker_failures={self.breaker_failures}, "
                f"breaker_cooldown_ms={self.breaker_cooldown_ms}, "
                f"affinity={self.affinity})")


class _Replica:
    """Router-side view of one engine: breaker state + dispatch counts."""

    def __init__(self, idx: int, service: GenerationService):
        self.idx = idx
        self.service = service
        self.breaker = _CLOSED
        self.consec_failures = 0
        self.opened_at: Optional[float] = None
        self.dispatches = 0
        self.dead = False  # declared dead; resubmission already performed


class _Record:
    """One outstanding client request: enough to resubmit it verbatim."""

    __slots__ = ("prompt", "kwargs", "stream", "replica_idx", "error",
                 "resubmits", "cancelled", "trace")

    def __init__(self, prompt, kwargs, stream, replica_idx, trace=None):
        self.prompt = prompt
        self.kwargs = kwargs
        self.stream = stream            # swapped atomically on resubmit
        self.replica_idx = replica_idx
        self.error: Optional[BaseException] = None
        self.resubmits = 0
        self.cancelled = False
        self.trace = trace              # one trace id across replica hops

    @property
    def done(self) -> bool:
        return self.error is not None or self.stream.finished


class RouterStream:
    """Client handle that survives replica failover: it always reads from
    the record's CURRENT underlying stream, so a resubmission (which only
    happens before any token was emitted) is invisible to the caller."""

    def __init__(self, record: _Record):
        self._rec = record

    @property
    def request_id(self) -> int:
        """The engine-local request id on the CURRENT replica (changes if
        the request is resubmitted after a replica death)."""
        return self._rec.stream.request_id

    @property
    def replica(self) -> int:
        return self._rec.replica_idx

    def result(self, timeout: Optional[float] = None):
        t_end = None if timeout is None else time.perf_counter() + timeout
        while True:
            rec = self._rec
            if rec.error is not None:
                raise rec.error
            inner = rec.stream
            remaining = (None if t_end is None
                         else t_end - time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"generation request still running after {timeout}s")
            poll = 0.05 if remaining is None else min(0.05, remaining)
            try:
                out = inner.result(poll)
            except TimeoutError:
                continue  # re-check for failover/typed error, then re-wait
            if rec.error is not None:
                raise rec.error
            if inner is rec.stream:
                return out
            # swapped underneath a completed wait (rare): read the new one

    def __iter__(self):
        while True:
            rec = self._rec
            if rec.error is not None:
                raise rec.error
            try:
                kind, payload = rec.stream._req.out_queue.get(timeout=0.05)
            except queue.Empty:
                continue  # re-check the (possibly swapped) stream
            if kind == "tok":
                yield payload
            elif kind == "done":
                return
            else:  # "error"
                raise payload

    def cancel(self) -> None:
        self._rec.cancelled = True
        self._rec.stream.cancel()

    @property
    def finished(self) -> bool:
        return self._rec.done

    @property
    def finish_reason(self) -> Optional[str]:
        return self._rec.stream.finish_reason

    @property
    def ttft_ms(self) -> Optional[float]:
        return self._rec.stream.ttft_ms

    @property
    def started(self) -> bool:
        """Whether the current replica's engine has emitted a token (once
        true, the request can no longer move replicas on failure)."""
        return self._rec.stream.started

    @property
    def resubmits(self) -> int:
        return self._rec.resubmits

    @property
    def trace_id(self) -> Optional[str]:
        """The request's trace id — stable across replica failover (the
        resubmitted engine request continues the same trace)."""
        return None if self._rec.trace is None else self._rec.trace.trace_id

    def stats(self) -> dict:
        """The CURRENT engine request's wide-event record (or live
        snapshot), plus router-level failover counts."""
        out = self._rec.stream.stats()
        out["router_replica"] = self._rec.replica_idx
        out["resubmits"] = self._rec.resubmits
        return out


class GenerationRouter:
    """N generation replicas behind one health-gated front-end.

    Parameters
    ----------
    params, model_cfg : forwarded to each :class:`GenerationService` when
        ``replicas`` is not given.
    gen_config : :class:`GenerationConfig` shared by every built replica
        (services only read it).
    config : :class:`RouterConfig`
    replicas : explicit list of pre-built services (tests / heterogeneous
        fleets); overrides ``params``/``model_cfg``/``gen_config``.
    start : launch replica engine loops + the probe thread immediately.
    device : the device built replicas run on (default ``cuda``; pass
        ``"cpu"`` to run on the CPU).
    """

    def __init__(self, params=None, model_cfg=None,
                 gen_config: Optional[GenerationConfig] = None,
                 config: Optional[RouterConfig] = None,
                 replicas: Optional[List[GenerationService]] = None,
                 start: bool = True, device=None):
        self._config = config or RouterConfig()
        if replicas is None:
            if params is None or model_cfg is None:
                raise ValueError(
                    "either pass pre-built replicas or params + model_cfg")
            replicas = [
                GenerationService(params, model_cfg,
                                  gen_config or GenerationConfig(),
                                  start=False, device=device)
                for _ in range(self._config.num_replicas)]
        self._replicas = []
        for i, svc in enumerate(replicas):
            svc._replica_id = i  # wide events/spans name the fleet index
            self._replicas.append(_Replica(i, svc))
        self._lock = threading.Lock()
        self._records: List[_Record] = []
        # shared-prefix affinity: chain hash of the leading prompt blocks
        # -> the replica that last served that prefix (bounded LRU)
        self._affinity: "OrderedDict[bytes, int]" = OrderedDict()
        self._affinity_bs = int(
            self._replicas[0].service._config.block_size)
        self._closed = False
        self._stop_probe = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._signal_unregister: Optional[Callable[[], None]] = None

        reg = _obs.registry()
        self._c_dispatch = reg.counter(
            "router_dispatches_total",
            help="requests dispatched to a replica (resubmits included)")
        self._c_resubmit = reg.counter(
            "router_resubmits_total",
            help="requests moved from a dead replica to a healthy one")
        self._c_breaker = reg.counter(
            "router_breaker_transitions_total",
            help="circuit-breaker state transitions across all replicas")
        self._c_replica_fail = reg.counter(
            "router_replica_failures_total",
            help="replicas declared dead by the health probe")
        self._g_healthy = reg.gauge(
            "router_healthy_replicas",
            help="replicas currently taking traffic (breaker closed)")
        self._c_affinity = reg.counter(
            "router_affinity_dispatches_total",
            help="dispatches routed to the replica that last served the "
                 "request's leading prompt blocks (shared-prefix "
                 "affinity)")
        self._g_healthy.set(len(self._replicas))
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------------
    def start(self) -> None:
        """Launch every replica's engine loop and the probe thread
        (idempotent)."""
        for rep in self._replicas:
            rep.service.start()
        if self._probe_thread is None or not self._probe_thread.is_alive():
            self._stop_probe.clear()
            t = threading.Thread(target=self._probe_loop,
                                 name="tpumx-router-probe", daemon=True)
            self._probe_thread = t
            t.start()

    def warmup(self) -> int:
        """Warm every replica's program set; total programs compiled."""
        return sum(rep.service.warmup() for rep in self._replicas)

    def stop(self, drain: bool = True, timeout: Optional[float] = None,
             reject_queued: bool = False) -> None:
        self._closed = True
        self._stop_probe.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout)
        # two-phase: first mark every replica closed (rejecting queued
        # work fleet-wide at once), THEN drain-join them — a sequential
        # close-and-drain would let later replicas keep admitting queued
        # requests while earlier ones drain
        for rep in self._replicas:
            rep.service.stop(drain=drain, timeout=0,
                             reject_queued=reject_queued)
        for rep in self._replicas:
            rep.service.stop(drain=drain, timeout=timeout,
                             reject_queued=reject_queued)
        self.uninstall_signal_handlers()

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Graceful preemption shutdown: every
        replica's running slots finish, queued requests are rejected."""
        _obs.registry().counter(
            "serving_graceful_shutdowns_total",
            help="graceful (signal-driven) service shutdowns").inc()
        self.stop(drain=True, timeout=timeout, reject_queued=True)

    def install_signal_handlers(self, signals=None) -> bool:
        """Drain-on-SIGTERM/SIGINT through the process-wide hub, the same
        hook Module.fit and the single-replica services use."""
        from ..fault.preemption import DEFAULT_SIGNALS, install_shutdown_hook

        if self._signal_unregister is not None:
            return True
        _flight.install()  # a preempted fleet leaves its black box
        self._signal_unregister = install_shutdown_hook(
            lambda signum: self.shutdown(), signals or DEFAULT_SIGNALS)
        return self._signal_unregister is not None

    def uninstall_signal_handlers(self) -> None:
        unreg = self._signal_unregister
        if unreg is not None:
            self._signal_unregister = None
            unreg()
            _flight.uninstall()  # symmetric with install_signal_handlers

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- dispatch -----------------------------------------------------------------
    def _eligible(self) -> List[_Replica]:
        out = []
        for rep in self._replicas:
            if rep.breaker == _OPEN:
                continue
            if not rep.service.health()["alive"]:
                continue
            out.append(rep)
        return out

    def _affinity_key(self, prompt) -> Optional[bytes]:
        """Chain hash of the request's leading prompt blocks (up to
        ``affinity_blocks`` of them) — the same chained keying the
        engines' prefix index uses, so requests this maps to one replica
        are exactly the ones that can share KV blocks there.  None for
        prompts shorter than one block."""
        from .generation.prefix_cache import ROOT_KEY, chain_hash

        toks = _np.asarray(prompt).ravel()
        bs = self._affinity_bs
        n = min(len(toks) // bs, self._config.affinity_blocks)
        if n <= 0:
            return None
        key = ROOT_KEY
        for i in range(n):
            key = chain_hash(key, toks[i * bs:(i + 1) * bs])
        return key

    def _pick_replica(self, candidates, prompt):
        """Shared-prefix affinity over least-loaded dispatch: prefer the
        (eligible) replica that last served this prompt's leading blocks
        — its prefix cache already holds them — falling back to the
        least-loaded candidate, which also breaks first-sighting ties."""
        key = None
        rep = None
        if self._config.affinity:
            key = self._affinity_key(prompt)
            if key is not None:
                with self._lock:
                    idx = self._affinity.get(key)
                if idx is not None:
                    rep = next((c for c in candidates if c.idx == idx),
                               None)
                    if rep is not None:
                        self._c_affinity.inc()
        if rep is None:
            rep = min(candidates, key=lambda c: c.service.load())
        if key is not None:
            with self._lock:
                self._affinity[key] = rep.idx
                self._affinity.move_to_end(key)
                while len(self._affinity) > 4096:
                    self._affinity.popitem(last=False)
        return rep

    def submit(self, prompt, **kwargs) -> RouterStream:
        """Dispatch one request to the shared-prefix-affine (else
        least-loaded) healthy replica; returns a failover-surviving
        stream handle.  Keyword arguments are
        :meth:`GenerationService.submit`'s."""
        if self._closed:
            raise ServingClosedError("generation router is shut down")
        candidates = self._eligible()
        if not candidates:
            raise NoHealthyReplicaError(
                f"all {len(self._replicas)} replicas are circuit-broken "
                "or dead")
        rep = self._pick_replica(candidates, prompt)
        # one trace for the whole request lifecycle: reuse the caller's
        # context when one is active (a traced client), else mint a root;
        # the dispatch span narrows it and the engine inherits it through
        # the explicit trace_ctx handoff
        ctx = _trace.current_trace() or _trace.new_trace()
        with _trace.use_context(ctx):
            with _obs.span("router.dispatch", cat="serving",
                           args={"replica": rep.idx,
                                 "candidates": len(candidates)}):
                stream = rep.service.submit(
                    prompt, trace_ctx=_trace.current_trace(), **kwargs)
                rec = _Record(prompt, dict(kwargs), stream, rep.idx,
                              trace=ctx)
                with self._lock:
                    self._records.append(rec)
                rep.dispatches += 1
                self._c_dispatch.inc()
                # deterministic chaos: TPUMX_FAULT_GEN_KILL_REPLICA=N[@K]
                # kills replica N right AFTER its K-th accepted dispatch,
                # so the request is on a replica that dies before serving
                if _fault_injector().gen_kill_replica(rep.idx):
                    rep.service.kill()
        return RouterStream(rec)

    def generate(self, prompt, **kwargs) -> List[int]:
        """Blocking convenience wrapper: ``submit(...).result()``."""
        timeout = kwargs.pop("timeout", None)
        return self.submit(prompt, **kwargs).result(timeout)

    # -- health probing + circuit breaker -----------------------------------------
    def _probe_loop(self) -> None:
        interval = self._config.probe_interval_ms / 1e3
        while not self._stop_probe.wait(interval):
            try:
                self._probe_once()
            except Exception:  # the probe must outlive any surprise
                pass

    def _probe_once(self) -> None:
        cfg = self._config
        now = time.perf_counter()
        healthy = 0
        for rep in self._replicas:
            try:
                h = rep.service.health()
            except Exception:
                h = {"alive": False, "consecutive_step_failures": 0}
            ok = bool(h.get("alive")) and (
                h.get("consecutive_step_failures", 0) < cfg.breaker_failures)
            if rep.breaker == _CLOSED:
                if ok:
                    rep.consec_failures = 0
                    healthy += 1
                else:
                    rep.consec_failures += 1
                    # a dead engine breaks immediately — every probe until
                    # the threshold would hang more client streams
                    if (not h.get("alive")
                            or rep.consec_failures >= cfg.breaker_failures):
                        self._transition(rep, _OPEN, now)
                        if not h.get("alive"):
                            self._handle_dead_replica(rep)
                        # dump only AFTER the dead replica's queued work
                        # is resubmitted: postmortem capture must never
                        # delay or suppress the failover guarantee
                        self._dump_breaker_open(rep)
            elif rep.breaker == _OPEN:
                if now - (rep.opened_at or now) >= \
                        cfg.breaker_cooldown_ms / 1e3:
                    self._transition(rep, _HALF_OPEN, now)
            if rep.breaker == _HALF_OPEN:
                if ok:
                    self._transition(rep, _CLOSED, now)
                    rep.consec_failures = 0
                    healthy += 1
                else:
                    self._transition(rep, _OPEN, now)
                    self._dump_breaker_open(rep)
        self._g_healthy.set(healthy)
        with self._lock:
            self._records = [rec for rec in self._records if not rec.done]

    def _transition(self, rep: _Replica, state: str, now: float) -> None:
        if rep.breaker == state:
            return
        prev = rep.breaker
        rep.breaker = state
        if state == _OPEN:
            rep.opened_at = now
        self._c_breaker.inc()
        _flight.note("breaker", {"replica": rep.idx, "from": prev,
                                 "to": state})

    def _dump_breaker_open(self, rep: _Replica) -> None:
        # a breaker opening means a replica just went dark under traffic —
        # dump the black box while the evidence is fresh.  Belt and
        # suspenders with dump()'s own never-raise contract: an escaping
        # exception here would be swallowed by _probe_loop and skip the
        # rest of the probe pass
        try:
            _flight.dump("breaker_open", extra={"replica": rep.idx})
        except Exception:
            pass

    def _handle_dead_replica(self, rep: _Replica) -> None:
        """Failure isolation: resubmit every request the dead replica
        accepted but never started streaming; fail mid-stream ones with a
        typed error (no silent hangs, no duplicate tokens)."""
        if rep.dead:
            return
        rep.dead = True
        self._c_replica_fail.inc()
        with self._lock:
            affected = [rec for rec in self._records
                        if rec.replica_idx == rep.idx and not rec.done]
        for rec in affected:
            if rec.cancelled:
                continue
            if rec.stream.started:
                rec.error = ReplicaDeadError(
                    f"replica {rep.idx} died after request "
                    f"{rec.stream.request_id} started streaming")
                continue
            try:
                self._resubmit(rec)
            except Exception as exc:  # no healthy target: typed failure
                rec.error = exc if isinstance(exc, ServingError) else \
                    ServingError(f"resubmit failed: {exc!r}")

    def _resubmit(self, rec: _Record) -> None:
        candidates = self._eligible()
        if not candidates:
            raise NoHealthyReplicaError(
                "dead replica's queued work has no healthy target")
        rep = min(candidates, key=lambda c: c.service.load())
        if self._config.affinity:
            # future shared-prefix arrivals follow the work, not the corpse
            key = self._affinity_key(rec.prompt)
            if key is not None:
                with self._lock:
                    self._affinity[key] = rep.idx
                    self._affinity.move_to_end(key)
        t0 = time.perf_counter()
        from_idx = rec.replica_idx
        # the SAME trace context crosses the replica hop — the new
        # replica's spans continue the dead one's trace
        stream = rep.service.submit(rec.prompt, trace_ctx=rec.trace,
                                    **rec.kwargs)
        rec.replica_idx = rep.idx
        rec.stream = stream  # swap is the failover commit point
        rec.resubmits += 1
        rep.dispatches += 1
        self._c_dispatch.inc()
        self._c_resubmit.inc()
        _trace.record_event("router.resubmit", "serving", t0,
                            time.perf_counter(), ctx=rec.trace,
                            args={"from": from_idx, "to": rep.idx})

    # -- introspection ------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            outstanding = sum(1 for rec in self._records if not rec.done)
            resubmits = sum(rec.resubmits for rec in self._records)
        reps = []
        for rep in self._replicas:
            try:
                h = rep.service.health()
            except Exception as exc:
                h = {"alive": False, "error": repr(exc)}
            reps.append({"idx": rep.idx, "breaker": rep.breaker,
                         "dead": rep.dead, "dispatches": rep.dispatches,
                         "health": h})
        with self._lock:
            affinity_entries = len(self._affinity)
        return {
            "replicas": reps,
            "healthy": sum(1 for r in reps
                           if r["breaker"] == _CLOSED and r["health"]["alive"]),
            "outstanding": outstanding,
            "resubmits_outstanding": resubmits,
            "dispatches": sum(rep.dispatches for rep in self._replicas),
            "affinity": self._config.affinity,
            "affinity_entries": affinity_entries,
            "closed": self._closed,
        }
