"""Deterministic fault injection.

PyTorch counterpart of ``mxnet_tpu/fault/inject.py``, whole: every
``TPUMX_FAULT_*`` spec parses as in the reference.  The port's generation
engine and router consume ``TPUMX_FAULT_GEN_STEP_FAIL`` and
``TPUMX_FAULT_GEN_KILL_REPLICA``; the kvstore, preemption and checkpoint
sites belong to modules not ported yet, and their counters are kept for
them.

Faults are declared up front through ``TPUMX_FAULT_*`` environment
variables and consumed by *occurrence counters*, so a test (or a chaos
drill) states exactly which message/step/file fails and the run is
reproducible:

- ``TPUMX_FAULT_KV_DROP="push:1,2;pull:3"`` — drop the Nth occurrence of
  each named kvstore request (1-based, counted per op on the worker).  A
  dropped request never reaches the wire; the worker sees it as a timeout
  and the retry/backoff path (``TPUMX_KV_RETRIES``) must recover it.
- ``TPUMX_FAULT_KV_DELAY_MS="push:200"`` or ``"push:200@1,2"`` — sleep
  before sending every (or the Nth) matching request, exercising timeout
  margins without a real slow network.
- ``TPUMX_FAULT_KV_KILL_SERVER=N`` — the kvstore server stops accepting
  and closes its socket after handling N messages, simulating a host dying
  mid-round; workers must surface a peer-naming error in bounded time.
- ``TPUMX_FAULT_PREEMPT_AT_STEP=N`` — ``Module.fit`` delivers a real
  SIGTERM to the process after global step N, driving the SAME handler
  path an evicted preemptible VM would (final synchronous checkpoint,
  graceful exit).
- ``TPUMX_FAULT_CKPT_CORRUPT="truncate"|"flip"[@N]`` — the checkpoint
  manager corrupts the Nth committed checkpoint right after writing it
  (every one without ``@N``), proving restore falls back to the previous
  retained checkpoint via checksum validation.
- ``TPUMX_FAULT_GEN_STEP_FAIL=N[@rid]`` — the generation engine's Nth
  decode-step invocation raises before the program is dispatched.  Bare
  ``N`` is one-shot (the retry path must absorb it with zero blast
  radius); ``N@rid`` poisons request ``rid`` persistently from the Nth
  invocation on — every decode batch containing it fails, so the
  bisect-quarantine path must isolate exactly that request.
- ``TPUMX_FAULT_GEN_KILL_REPLICA=N[@K]`` — the generation router kills
  replica index ``N`` right after dispatching its ``K``-th request to it
  (default 1): the engine loop exits abruptly, streams hang, and the
  router's health probe / circuit breaker / resubmission path must
  recover.

Specs are parsed STRICTLY at :meth:`FaultInjector.reset`: a malformed
token raises :class:`~mxnet_tpu_torch.base.MXNetError` naming the environment
variable and the offending token — a typo'd chaos drill must fail loudly,
never silently inject nothing.  All counters live in one process-wide
:class:`FaultInjector` (``injector()``); ``reset()`` re-reads the
environment — tests flip env vars per case.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["FaultInjector", "FaultInjectedError", "injector",
           "corrupt_checkpoint"]


class FaultInjectedError(MXNetError):
    """An injected fault fired (only raised by injection sites themselves;
    recovery paths are expected to translate or absorb it)."""


def _int_token(var: str, tok: str, minimum: int = 1) -> int:
    """Strictly parse one integer token of a ``TPUMX_FAULT_*`` spec."""
    tok = tok.strip()
    try:
        n = int(tok)
    except ValueError:
        raise MXNetError(
            f"{var}: bad token {tok!r} (expected an integer)") from None
    if n < minimum:
        raise MXNetError(f"{var}: bad token {tok!r} (must be >= {minimum})")
    return n


def _float_token(var: str, tok: str) -> float:
    tok = tok.strip()
    try:
        return float(tok)
    except ValueError:
        raise MXNetError(
            f"{var}: bad token {tok!r} (expected a number)") from None


def _parse_occurrences(var: str, spec: str) -> Dict[str, List[int]]:
    """``"push:1,2;pull:3"`` -> {"push": [1, 2], "pull": [3]}."""
    out: Dict[str, List[int]] = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise MXNetError(
                f"{var}: bad token {part!r} (expected 'op:n[,n...]')")
        op, ns = part.split(":", 1)
        if not op.strip():
            raise MXNetError(
                f"{var}: bad token {part!r} (empty op name)")
        occ = [_int_token(var, n) for n in ns.split(",") if n.strip()]
        if not occ:
            raise MXNetError(
                f"{var}: bad token {part!r} (no occurrence numbers)")
        out[op.strip()] = sorted(occ)
    return out


def _parse_delays(var: str,
                  spec: str) -> Dict[str, Tuple[float, Optional[List[int]]]]:
    """``"push:200"`` (every push) or ``"push:200@1,2"`` (1st and 2nd)."""
    out: Dict[str, Tuple[float, Optional[List[int]]]] = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise MXNetError(
                f"{var}: bad token {part!r} (expected 'op:ms[@n,...]')")
        op, rest = part.split(":", 1)
        if not op.strip():
            raise MXNetError(f"{var}: bad token {part!r} (empty op name)")
        if "@" in rest:
            ms, ns = rest.split("@", 1)
            occ: Optional[List[int]] = sorted(
                _int_token(var, n) for n in ns.split(",") if n.strip())
            if not occ:
                raise MXNetError(
                    f"{var}: bad token {part!r} (no occurrence numbers "
                    "after '@')")
        else:
            ms, occ = rest, None
        out[op.strip()] = (_float_token(var, ms), occ)
    return out


def _parse_at_pair(var: str, spec: str, default_second: Optional[int] = None
                   ) -> Optional[Tuple[int, Optional[int]]]:
    """``"N"`` or ``"N@M"`` -> (N, M or ``default_second``)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    if "@" in spec:
        first, second = spec.split("@", 1)
        return (_int_token(var, first, minimum=0),
                _int_token(var, second, minimum=0))
    return (_int_token(var, spec, minimum=0), default_second)


class FaultInjector:
    """Process-wide occurrence-counted fault state (see module docs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Re-read the ``TPUMX_FAULT_*`` environment and zero every
        occurrence counter (tests call this per case).  Parsing is strict
        — a malformed spec raises :class:`MXNetError` naming the variable
        and the bad token, leaving the previous configuration in place."""
        drops = _parse_occurrences(
            "TPUMX_FAULT_KV_DROP", os.environ.get("TPUMX_FAULT_KV_DROP", ""))
        delays = _parse_delays(
            "TPUMX_FAULT_KV_DELAY_MS",
            os.environ.get("TPUMX_FAULT_KV_DELAY_MS", ""))
        kill = os.environ.get("TPUMX_FAULT_KV_KILL_SERVER", "").strip()
        kill_after = (_int_token("TPUMX_FAULT_KV_KILL_SERVER", kill)
                      if kill else None)
        pre = os.environ.get("TPUMX_FAULT_PREEMPT_AT_STEP", "").strip()
        preempt_step = (_int_token("TPUMX_FAULT_PREEMPT_AT_STEP", pre,
                                   minimum=0) if pre else None)
        ck = os.environ.get("TPUMX_FAULT_CKPT_CORRUPT", "").strip()
        if ck and "@" in ck:
            mode, n = ck.split("@", 1)
            ckpt_mode, ckpt_at = mode.strip(), _int_token(
                "TPUMX_FAULT_CKPT_CORRUPT", n)
        else:
            ckpt_mode, ckpt_at = (ck or None), None
        if ckpt_mode is not None and ckpt_mode not in ("truncate", "flip"):
            raise MXNetError(
                f"TPUMX_FAULT_CKPT_CORRUPT: bad token {ckpt_mode!r} "
                "(expected 'truncate' or 'flip')")
        # generation serving faults
        gen_step = _parse_at_pair(
            "TPUMX_FAULT_GEN_STEP_FAIL",
            os.environ.get("TPUMX_FAULT_GEN_STEP_FAIL", ""))
        kill_replica = _parse_at_pair(
            "TPUMX_FAULT_GEN_KILL_REPLICA",
            os.environ.get("TPUMX_FAULT_GEN_KILL_REPLICA", ""),
            default_second=1)
        with self._lock:
            self._drops = drops
            self._delays = delays
            self._kill_after = kill_after
            self._preempt_step = preempt_step
            self._ckpt_mode, self._ckpt_at = ckpt_mode, ckpt_at
            self._gen_step_fail = gen_step          # (N, rid or None)
            self._kill_replica = kill_replica       # (replica idx, after K)
            self._counts: Dict[str, int] = {}

    def _bump(self, site: str) -> int:
        n = self._counts.get(site, 0) + 1
        self._counts[site] = n
        return n

    # -- kvstore worker side -------------------------------------------------------
    def kv_fault(self, op: str) -> bool:
        """Called once per outbound kvstore request.  Applies any configured
        delay, then returns True when THIS occurrence must be dropped (the
        caller simulates a timeout instead of sending)."""
        with self._lock:
            if not self._drops and not self._delays:
                return False
            n = self._bump(f"kv:{op}")
            delay = self._delays.get(op)
            drop = n in self._drops.get(op, ())
        if delay is not None:
            ms, occ = delay
            if occ is None or n in occ:
                time.sleep(ms / 1e3)
        return drop

    # -- kvstore server side -------------------------------------------------------
    def server_kill_due(self) -> bool:
        """Called once per handled server message: True exactly when the
        configured message budget is exhausted — the server then dies."""
        if self._kill_after is None:
            return False
        with self._lock:
            return self._bump("kv:server_msg") >= self._kill_after

    # -- training preemption -------------------------------------------------------
    def preempt_due(self, global_step: int) -> bool:
        """Whether the injected preemption fires at (or before) this step.
        One-shot: consumed on first True."""
        with self._lock:
            if self._preempt_step is None:
                return False
            if global_step >= self._preempt_step:
                self._preempt_step = None
                return True
            return False

    # -- generation serving --------------------------------------------------------
    def gen_step_fail(self, rids) -> bool:
        """Called once per decode-step program invocation with the request
        ids in the batch.  Bare ``N`` specs fire exactly on the Nth
        invocation (one-shot — the engine's retry must recover); ``N@rid``
        specs poison request ``rid`` from the Nth invocation on, so every
        batch containing it fails until bisection quarantines it."""
        with self._lock:
            if self._gen_step_fail is None:
                return False
            n_at, rid = self._gen_step_fail
            n = self._bump("gen:step")
            if rid is None:
                return n == n_at
            return n >= n_at and rid in rids

    def gen_kill_replica(self, replica_idx: int) -> bool:
        """Called by the router after each dispatch to ``replica_idx``:
        True exactly when the injected replica death must fire (replica
        ``N`` after its ``K``-th dispatch; one-shot)."""
        with self._lock:
            if self._kill_replica is None:
                return False
            idx, after = self._kill_replica
            if int(replica_idx) != idx:
                return False
            if self._bump(f"gen:replica{idx}:dispatch") >= (after or 1):
                self._kill_replica = None
                return True
            return False

    # -- checkpoint corruption -----------------------------------------------------
    def ckpt_corrupt_mode(self) -> Optional[str]:
        """Corruption mode for the checkpoint that was JUST committed, or
        None.  With ``@N`` only the Nth commit is corrupted."""
        with self._lock:
            if self._ckpt_mode is None:
                return None
            n = self._bump("ckpt:commit")
            if self._ckpt_at is not None and n != self._ckpt_at:
                return None
            return self._ckpt_mode


_injector = FaultInjector()


def injector() -> FaultInjector:
    """The process-wide :class:`FaultInjector`."""
    return _injector


def corrupt_checkpoint(path: str, mode: str = "truncate") -> str:
    """Corrupt a committed checkpoint in place (test harness + the
    ``TPUMX_FAULT_CKPT_CORRUPT`` hook).

    ``path`` is a checkpoint directory (its largest data file is hit) or a
    single file.  ``mode``: ``"truncate"`` cuts the file to half its length;
    ``"flip"`` XOR-flips one byte in the middle (same length — only the
    checksum can tell).  Returns the path of the file corrupted.
    """
    target = path
    if os.path.isdir(path):
        candidates = [os.path.join(path, f) for f in sorted(os.listdir(path))
                      if not f.endswith(".json")]
        if not candidates:
            raise MXNetError(f"corrupt_checkpoint: no data files in {path}")
        target = max(candidates, key=os.path.getsize)
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "flip":
        with open(target, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
    else:
        raise MXNetError(
            f"corrupt_checkpoint: unknown mode {mode!r} "
            "(expected 'truncate' or 'flip')")
    return target
