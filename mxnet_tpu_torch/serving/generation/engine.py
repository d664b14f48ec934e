"""GenerationService — continuous-batching autoregressive decoding.

PyTorch counterpart of ``mxnet_tpu/serving/generation/engine.py``.  The
scheduling model is the reference's (Orca's iteration-level scheduling
over vLLM's paged KV cache):

- the engine owns ``max_slots`` decode slots; every loop iteration it
  (1) evicts finished/cancelled/expired requests and frees their cache
  blocks, (2) under incremental allocation (the default,
  ``preemption=True``) preempts victims when the pool crosses its high
  watermark and grows every running request's block table (by the whole
  span one iteration may write: 1, ``draft_k + 1`` or ``multistep_k``),
  oldest admitted first, (3) admits waiting requests into free slots —
  priority classes first, FIFO within a class — reusing cached prompt
  blocks when the prefix cache (default on) holds them, and prefills their
  uncached context through the bucketed (past the smallest rung, chunked)
  prefill, then (4) runs ONE decode dispatch over all occupied slots;
- the decode dispatch is one of three steps that emit identical token
  values: with ``speculative=True`` and drafts proposed (n-gram prompt
  lookup or a draft model), one multi-query verify step; else, with
  ``multistep_k > 1`` and no request waiting (or inside an
  ``engine.bulk(k)`` scope), k decode iterations in one dispatch (on the
  card one CUDA-graph replay); else the single-token step;
- a failed decode step is retried once, then bisected so only the suspect
  request is quarantined with a typed :class:`GenerationStepError` while
  healthy slots keep decoding; requests a failing iteration never touched
  are requeued (bounded), not failed;
- the steady-state step set is finite, enumerated by :meth:`warmup`
  (which calls ``observability.mark_warm()``) and guarded by
  ``TPUMX_FREEZE_COMPILES=1``;
- tokens stream back per request through :class:`GenerationStream`, with
  the queue bound, backpressure policies and deadlines of the reference;
- observability: ``serving.*`` spans, per-request trace contexts and wide
  events, gauges for tokens/sec, KV-block occupancy and running/waiting
  requests, TTFT and inter-token histograms, all in the process registry;
  flight-recorder dumps on quarantine; ``health()``/``load()``/``kill()``
  for the router.

The model steps run on the service's device (default ``cuda``) through
the port's CUDA kernels: fused LayerNorm and paged attention, whose
int8-pool variant serves ``kv_dtype="int8"`` (``mxnet_tpu_torch.ops``).
Greedy and sampled tokens match the JAX package's for the same
parameters: sampling is keyed on (request seed, position) with the
reference's threefry bits.  Model-parallel serving (``mp_devices > 1``,
:class:`GenerationService`) runs every step kind, speculative and
multi-step decode included.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ... import observability as _obs
from ...base import MXNetError, getenv
from ...fault.inject import FaultInjectedError
from ...fault.inject import injector as _fault_injector
from ...observability import flight_recorder as _flight
from ...observability import tracing as _trace
from ..batcher import (BACKPRESSURE_POLICIES, DeadlineExceededError,
                       QueueFullError, RequestShedError, ServingClosedError,
                       ServingError)
from ..bucketing import (batch_buckets, bucket_batch, bucket_seq_len,
                         pad_tokens_right, seq_buckets)
from .kv_cache import PagedKVCache, blocks_for
from .prefix_cache import PrefixCacheIndex
from .programs import GenerationPrograms

__all__ = ["GenerationConfig", "GenerationService", "GenerationStream",
           "GenerationStepError"]


class GenerationStepError(ServingError):
    """A decode step failed for this specific request even after the
    retry, and bisection isolated it (the quarantine outcome) — or the
    request exhausted its error-requeue budget.  Other requests in the
    same batch keep decoding."""


_WAITING, _RUNNING, _FINISHED, _CANCELLED, _FAILED = (
    "waiting", "running", "finished", "cancelled", "failed")

_AMP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GenerationConfig:
    """Knobs for :class:`GenerationService`, with the reference's names,
    defaults, ``TPUMX_GEN_*`` environment variables and validation.
    Refused: any ``amp_dtype`` but float32/bfloat16 (the dtypes the
    port's kernels take; ``NotImplementedError``)."""

    def __init__(self, max_slots: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_new_tokens: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 backpressure: Optional[str] = None,
                 default_deadline_ms: Optional[float] = None,
                 amp_dtype: Optional[str] = None,
                 eos_token: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 mp_devices: Optional[int] = None,
                 shard_rules=None,
                 preemption: Optional[bool] = None,
                 watermark_high: Optional[float] = None,
                 watermark_low: Optional[float] = None,
                 admission_budget: Optional[float] = None,
                 kv_dtype: Optional[str] = "__env__",
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_blocks: Optional[int] = None,
                 speculative: Optional[bool] = None,
                 draft_mode: Optional[str] = None,
                 draft_k: Optional[int] = None,
                 draft_ngram: Optional[int] = None,
                 draft_window: Optional[int] = None,
                 multistep_k: Optional[int] = None):
        self.max_slots = int(max_slots if max_slots is not None
                             else getenv("TPUMX_GEN_SLOTS", 4))
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.block_size = int(block_size if block_size is not None
                              else getenv("TPUMX_GEN_BLOCK_SIZE", 16))
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else getenv("TPUMX_GEN_NUM_BLOCKS", 128))
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else getenv("TPUMX_GEN_MAX_NEW_TOKENS", 64))
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.queue_bound = int(queue_bound if queue_bound is not None
                               else getenv("TPUMX_GEN_QUEUE_BOUND", 256))
        if self.queue_bound < 1:
            raise ValueError("queue_bound must be >= 1")
        self.backpressure = (backpressure if backpressure is not None
                             else getenv("TPUMX_GEN_BACKPRESSURE", "block"))
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, "
                f"got {self.backpressure!r}")
        env_deadline = os.environ.get("TPUMX_GEN_DEADLINE_MS")
        if default_deadline_ms is not None:
            self.default_deadline_ms: Optional[float] = float(default_deadline_ms)
        elif env_deadline:
            self.default_deadline_ms = float(env_deadline)
        else:
            self.default_deadline_ms = None
        # low-precision decode: params and the float KV pool in this dtype
        env_amp = (os.environ.get("TPUMX_GEN_AMP_DTYPE")
                   or os.environ.get("TPUMX_SERVING_AMP_DTYPE"))
        self.amp_dtype: Optional[str] = (
            str(amp_dtype) if amp_dtype is not None else (env_amp or None))
        if self.amp_dtype is not None and self.amp_dtype not in _AMP_DTYPES:
            raise NotImplementedError(
                f"amp_dtype {self.amp_dtype!r}: the port's kernels take "
                f"{sorted(_AMP_DTYPES)}")
        self.seq_buckets = (sorted(int(b) for b in seq_buckets)
                            if seq_buckets else None)
        self.eos_token = None if eos_token is None else int(eos_token)
        # chunked prefill: prompts past the smallest rung split into
        # rung-sized chunks through the same cache-aware prefill step
        self.chunked_prefill = bool(
            chunked_prefill if chunked_prefill is not None
            else getenv("TPUMX_GEN_CHUNKED_PREFILL", 1))
        # model-parallel serving: one process per device, the params
        # sharded per shard_rules (default: the transformer's rules)
        self.mp_devices = int(mp_devices if mp_devices is not None
                              else getenv("TPUMX_GEN_MP_DEVICES", 1))
        if self.mp_devices < 1:
            raise ValueError("mp_devices must be >= 1")
        self.shard_rules = shard_rules
        # incremental KV allocation + victim preemption: admission takes
        # the blocks the context needs, decode grows the table at block
        # boundaries, pool pressure preempts the newest-admitted
        # lowest-priority request; False = reserve-ahead admission
        self.preemption = bool(preemption if preemption is not None
                               else getenv("TPUMX_GEN_PREEMPTION", True))
        self.watermark_high = float(
            watermark_high if watermark_high is not None
            else getenv("TPUMX_GEN_WATERMARK_HIGH", 0.95))
        self.watermark_low = float(
            watermark_low if watermark_low is not None
            else getenv("TPUMX_GEN_WATERMARK_LOW", 0.80))
        if not (0.0 < self.watermark_low <= self.watermark_high <= 1.0):
            raise ValueError(
                f"watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={self.watermark_low}, high={self.watermark_high}")
        # int8 paged KV cache: int8 K/V with per-(layer, block, head)
        # scales, quantized at scatter and dequantized at read
        if kv_dtype == "__env__":
            raw = os.environ.get("TPUMX_GEN_KV_DTYPE", "").strip().lower()
            kv_dtype = None if raw in ("", "0", "none", "off") else raw
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        # submissions whose projected blocks (queued + running) would
        # exceed this multiple of the pool hit the backpressure policy
        self.admission_budget = float(
            admission_budget if admission_budget is not None
            else getenv("TPUMX_GEN_ADMISSION_BUDGET", 4.0))
        if self.admission_budget <= 0:
            raise ValueError("admission_budget must be > 0")
        # prefix caching: share read-only resident KV blocks of equal
        # prompt prefixes, prefill only the uncached suffix
        self.prefix_cache = bool(
            prefix_cache if prefix_cache is not None
            else getenv("TPUMX_GEN_PREFIX_CACHE", True))
        # cap on blocks the index may keep resident (0 = bounded only by
        # the pool and eviction)
        self.prefix_cache_blocks = int(
            prefix_cache_blocks if prefix_cache_blocks is not None
            else getenv("TPUMX_GEN_PREFIX_CACHE_BLOCKS", 0))
        if self.prefix_cache_blocks < 0:
            raise ValueError("prefix_cache_blocks must be >= 0")
        # speculative decoding: a drafter proposes up to draft_k tokens
        # per slot and ONE multi-query verify step accepts/rejects them —
        # greedy output stays target-only, sampled output draws the same
        # tokens ((seed, position) keying)
        self.speculative = bool(
            speculative if speculative is not None
            else getenv("TPUMX_GEN_SPECULATIVE", 0))
        # "ngram" = self-speculative prompt lookup against the request's
        # own history (no second model); "model" = a small draft
        # transformer passed to GenerationService(draft_params=...)
        self.draft_mode = str(
            draft_mode if draft_mode is not None
            else getenv("TPUMX_GEN_DRAFT_MODE", "ngram")).strip().lower()
        if self.draft_mode not in ("ngram", "model"):
            raise ValueError(
                f"draft_mode must be 'ngram' or 'model', "
                f"got {self.draft_mode!r}")
        self.draft_k = int(draft_k if draft_k is not None
                           else getenv("TPUMX_GEN_DRAFT_K", 4))
        if self.draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        self.draft_ngram = int(draft_ngram if draft_ngram is not None
                               else getenv("TPUMX_GEN_DRAFT_NGRAM", 3))
        if self.draft_ngram < 1:
            raise ValueError("draft_ngram must be >= 1")
        self.draft_window = int(draft_window if draft_window is not None
                                else getenv("TPUMX_GEN_DRAFT_WINDOW", 32))
        if self.draft_window < 1:
            raise ValueError("draft_window must be >= 1")
        # multi-step decoding: up to k decode iterations in one dispatch
        # (one CUDA-graph replay on the card) when no request waits or
        # inside an engine.bulk scope; 1 = off
        self.multistep_k = int(multistep_k if multistep_k is not None
                               else getenv("TPUMX_GEN_MULTISTEP_K", 1))
        if self.multistep_k < 1:
            raise ValueError("multistep_k must be >= 1")

    def __repr__(self):
        return (f"GenerationConfig(max_slots={self.max_slots}, "
                f"block_size={self.block_size}, "
                f"num_blocks={self.num_blocks}, "
                f"seq_buckets={self.seq_buckets}, "
                f"max_new_tokens={self.max_new_tokens}, "
                f"backpressure={self.backpressure!r}, "
                f"amp_dtype={self.amp_dtype!r}, "
                f"kv_dtype={self.kv_dtype!r}, "
                f"preemption={self.preemption}, "
                f"prefix_cache={self.prefix_cache}, "
                f"speculative={self.speculative}, "
                f"multistep_k={self.multistep_k})")


class _GenRequest:
    """Engine-internal per-request state."""

    __slots__ = ("rid", "prompt_len", "seq_tokens", "bucket", "max_new",
                 "temperature", "top_k", "top_p", "seed", "eos_token",
                 "deadline", "on_token", "state", "blocks", "ctx_len",
                 "n_generated", "out_queue", "done_event", "error",
                 "finish_reason", "t_submit", "t_first", "t_last",
                 "cancel_requested", "priority", "admit_seq",
                 "n_preempted", "n_requeues", "trace", "seg_state",
                 "seg_t0", "breakdown", "breakdown_first", "rung_s",
                 "decode_steps", "n_retries", "token_log", "wide_event",
                 "lock", "cached_len", "cached_total", "cow_copies",
                 "charged_blocks", "draft_proposed", "draft_accepted",
                 "mode_tokens", "index_safe_len")

    def __init__(self, rid, prompt, bucket, max_new, temperature, top_k,
                 top_p, seed, eos_token, deadline, on_token, priority=0):
        self.rid = rid
        self.prompt_len = len(prompt)
        self.seq_tokens: List[int] = [int(t) for t in prompt]
        self.bucket = bucket
        self.max_new = max_new
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF
        self.eos_token = eos_token
        self.deadline = deadline
        self.on_token = on_token
        self.state = _WAITING
        self.blocks: Optional[List[int]] = None
        self.ctx_len = 0
        self.n_generated = 0
        self.out_queue: "queue.Queue" = queue.Queue()
        self.done_event = threading.Event()
        self.error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.cancel_requested = False
        self.priority = int(priority)
        self.admit_seq = -1        # admission recency, keys victim order
        self.n_preempted = 0       # watermark/growth preemptions survived
        self.n_requeues = 0        # error-path requeues consumed
        # prefix caching: tokens served from shared blocks at the LAST
        # admission / over the request's lifetime, CoW
        # copies taken, and the overload estimator's projected charge
        self.cached_len = 0
        self.cached_total = 0
        self.cow_copies = 0
        self.charged_blocks = 0
        # speculative decoding: drafts proposed for /
        # accepted by this request, tokens emitted per decode mode, and —
        # int8 pool only — the longest prefix whose quantized bits are
        # safe to index into the prefix cache (a partial-rejection verify
        # can requantize a boundary block under a transiently larger
        # scale; None = the whole context is safe)
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.mode_tokens: Dict[str, int] = {}
        self.index_safe_len: Optional[int] = None
        # latency attribution: the request's
        # lifetime is partitioned into contiguous segments — queue,
        # admission, prefill, decode, preempted — whose transition points
        # are the scheduling events below, so the components sum exactly
        # to measured wall time (and, snapshotted at first token, to TTFT)
        self.trace = None               # TraceContext handed across threads
        self.seg_state = "queue"
        self.seg_t0 = self.t_submit
        self.breakdown: Dict[str, float] = {}
        self.breakdown_first: Optional[Dict[str, float]] = None
        self.rung_s: Dict[int, float] = {}
        self.decode_steps = 0
        self.n_retries = 0
        self.token_log: List[float] = []
        self.wide_event: Optional[dict] = None
        # serializes seg() against GenerationStream.stats()'s live
        # snapshot: the engine mutates the segment partition OUTSIDE the
        # service lock (prefill/decode run unlocked), so without this a
        # caller could read a torn (seg_state, seg_t0) pair or catch
        # the breakdown dict mid-resize
        self.lock = threading.Lock()

    def seg(self, state: str, now: float) -> None:
        """Close the open lifetime segment at ``now`` and open ``state``."""
        with self.lock:
            self.breakdown[self.seg_state] = \
                self.breakdown.get(self.seg_state, 0.0) \
                + (now - self.seg_t0)
            self.seg_state = state
            self.seg_t0 = now

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            >= self.deadline

    @property
    def generated(self) -> List[int]:
        return self.seq_tokens[self.prompt_len:]


class GenerationStream:
    """Per-request handle: iterate generated tokens as they stream, or
    block on :meth:`result` for the full list."""

    def __init__(self, req: _GenRequest,
                 service: Optional["GenerationService"] = None):
        self._req = req
        self._service = service

    @property
    def request_id(self) -> int:
        return self._req.rid

    def __iter__(self):
        while True:
            kind, payload = self._req.out_queue.get()
            if kind == "tok":
                yield payload
            elif kind == "done":
                return
            else:  # "error"
                raise payload

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; the generated token ids."""
        if not self._req.done_event.wait(timeout):
            raise TimeoutError(
                f"generation request {self._req.rid} still running "
                f"after {timeout}s")
        if self._req.error is not None:
            raise self._req.error
        return list(self._req.generated)

    def cancel(self) -> None:
        """Ask the engine to evict this request at its next iteration."""
        self._req.cancel_requested = True

    @property
    def finished(self) -> bool:
        return self._req.done_event.is_set()

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def ttft_ms(self) -> Optional[float]:
        if self._req.t_first is None:
            return None
        return (self._req.t_first - self._req.t_submit) * 1e3

    @property
    def started(self) -> bool:
        """Whether the engine has emitted at least one token for this
        request (the router's resubmit-safety criterion: an unstarted
        request can move replicas without duplicate delivery)."""
        return self._req.t_first is not None

    @property
    def trace_id(self) -> Optional[str]:
        """The request's trace id (stable across threads and replica
        hops; None with ``TPUMX_TRACING=0``)."""
        return None if self._req.trace is None else self._req.trace.trace_id

    def stats(self) -> dict:
        """Per-request observability: the wide-event record once the
        request finished, or a live snapshot of the same shape while it
        runs — TTFT, per-token timestamps, the latency breakdown, and
        preemption/requeue/retry counts.  The
        live path snapshots under the request's segment lock so the
        breakdown is never torn against a concurrent seg() transition."""
        r = self._req
        ev = r.wide_event
        if ev is not None:
            return dict(ev)
        svc = self._service
        with r.lock:
            ev = r.wide_event  # may have finished while we acquired
            if ev is not None:
                return dict(ev)
            now = time.perf_counter()
            bd = dict(r.breakdown)
            bd[r.seg_state] = bd.get(r.seg_state, 0.0) + (now - r.seg_t0)
            first = r.breakdown_first
            rung = dict(r.rung_s)
            token_log = list(r.token_log)
            outcome, finish_reason = r.state, r.finish_reason
            error, t_first = r.error, r.t_first
            n_generated, decode_steps = r.n_generated, r.decode_steps
            preemptions, requeues = r.n_preempted, r.n_requeues
            retries = r.n_retries
            cached_total, cow_copies = r.cached_total, r.cow_copies
            draft_proposed = r.draft_proposed
            draft_accepted = r.draft_accepted
            mode_tokens = dict(r.mode_tokens)
        return {
            "type": "generation_request",
            "request_id": r.rid,
            "trace_id": self.trace_id,
            "replica": None if svc is None else svc._replica_id,
            "priority": r.priority,
            "prompt_tokens": r.prompt_len,
            "output_tokens": n_generated,
            "outcome": outcome,
            "finish_reason": finish_reason,
            "error": None if error is None else repr(error),
            "total_ms": round((now - r.t_submit) * 1e3, 3),
            "ttft_ms": (None if t_first is None
                        else round((t_first - r.t_submit) * 1e3, 3)),
            "ttft_breakdown_ms": (
                None if first is None
                else {k: round(v * 1e3, 3) for k, v in first.items()}),
            "breakdown_ms": {k: round(v * 1e3, 3) for k, v in bd.items()},
            "prefill_rungs_ms": {str(k): round(v * 1e3, 3)
                                 for k, v in rung.items()},
            "decode_steps": decode_steps,
            "preemptions": preemptions,
            "requeues": requeues,
            "retries": retries,
            "prefix_cached_tokens": cached_total,
            "cow_copies": cow_copies,
            "decode_mode": _dominant_mode(mode_tokens),
            "accepted_ratio": (None if draft_proposed == 0 else
                               round(draft_accepted / draft_proposed, 4)),
            "draft_proposed_tokens": draft_proposed,
            "draft_accepted_tokens": draft_accepted,
            "token_offsets_ms": [round((t - r.t_submit) * 1e3, 3)
                                 for t in token_log],
        }


def _dominant_mode(mode_tokens: Dict[str, int]) -> str:
    """The decode mode that emitted most of a request's tokens —
    the wide-event ``decode_mode`` field (``single`` when nothing has
    been emitted yet)."""
    if not mode_tokens:
        return "single"
    return max(mode_tokens.items(), key=lambda kv: (kv[1], kv[0]))[0]


class GenerationService:
    """Continuous-batching LM generation over a paged KV cache.

    Parameters
    ----------
    params : dict of tensors (or numpy arrays)
        Transformer LM parameters with the reference's keys
        (``transformer_lm_init`` / ``params_from_jax``).
    model_cfg : :class:`~mxnet_tpu_torch.parallel.transformer.TransformerConfig`
    config : :class:`GenerationConfig`, optional
    start : bool
        When False the engine loop is not launched until :meth:`start` —
        useful to enqueue a deterministic initial backlog (tests) or to
        :meth:`warmup` before taking traffic.
    draft_params, draft_cfg : the draft model of ``draft_mode="model"``
        (a ``transformer_lm_init`` layout with the target's vocabulary).
    device : the device the model and KV pool live on (default ``cuda``;
        pass ``"cpu"`` to run the plain versions on the CPU).

    **Model parallelism** (``config.mp_devices > 1``): every process of a
    world of ``mp_devices`` ranks (``tools/launch.py -n <mp>`` or
    torchrun; one process per device) builds the same service from the
    same whole params.  Rank 0 is the LEADER: it schedules, samples and
    takes requests; its signatures and :meth:`stats` keys are the
    reference's.  The other ranks are FOLLOWERS: from construction a
    thread of theirs runs each device step the leader announces on its
    own part (``programs.py``: its head slice, or the whole step on the
    gather route of heads or ``d_ff`` that mp does not divide); the
    leader alone drafts, verifies and samples, except that every rank
    samples the iterations of a multi-step decode.  On a follower
    :meth:`submit` (and
    so :meth:`generate`) raises ``MXNetError`` naming rank 0,
    :meth:`warmup` and :meth:`start` do nothing (the leader's drive it),
    and :meth:`stop` waits until the leader stops (or the group breaks,
    then it raises the failure).
    """

    _TPS_WINDOW = 5.0  # seconds of token timestamps behind the tokens/sec gauge

    def __init__(self, params, model_cfg, config: Optional[GenerationConfig]
                 = None, start: bool = True, draft_params=None,
                 draft_cfg=None, device=None):
        self._model_cfg = model_cfg
        self._config = config or GenerationConfig()
        self._replica_id = 0  # the router overwrites with the fleet index
        cfg = self._config
        compute_dtype = _AMP_DTYPES[cfg.amp_dtype] if cfg.amp_dtype else None
        self._programs = GenerationPrograms(params, model_cfg,
                                            compute_dtype=compute_dtype,
                                            device=device,
                                            kv_dtype=cfg.kv_dtype,
                                            mp_devices=cfg.mp_devices,
                                            shard_rules=cfg.shard_rules)
        self._device = self._programs.device
        # on the paged mp route each rank holds its head slice of the
        # pool; on the gather route the whole pool
        self._cache = PagedKVCache(
            model_cfg.n_layers, model_cfg.n_heads, model_cfg.d_head,
            cfg.num_blocks, cfg.block_size,
            dtype=compute_dtype or torch.float32, device=self._device,
            kv_dtype=cfg.kv_dtype, mp=self._programs.pool_mp)
        self._cache.allocator.set_watermarks(cfg.watermark_high,
                                             cfg.watermark_low)
        # the chain-hash index over resident full blocks; None with the
        # prefix cache off
        self._prefix = (PrefixCacheIndex(
            self._cache.allocator, cfg.block_size,
            capacity_blocks=cfg.prefix_cache_blocks)
            if cfg.prefix_cache else None)
        self._pc_evictions_seen = 0
        # prefill ladder: bounded by the model's position table — a prompt
        # must also leave room for at least one generated token
        max_prompt = model_cfg.max_len - 1
        self._seq_buckets = (cfg.seq_buckets if cfg.seq_buckets
                             else seq_buckets(max_prompt))
        if self._seq_buckets[-1] > max_prompt:
            raise ValueError(
                f"largest seq bucket {self._seq_buckets[-1]} exceeds the "
                f"model's max prompt length {max_prompt}")
        # decode block-table widths: pow2 ladder up to the blocks needed to
        # address max_len positions
        self._width_buckets = batch_buckets(
            blocks_for(model_cfg.max_len, cfg.block_size))
        # multi-token decoding: the verify chunk length Tk = s + 1 (pending
        # token + s drafts) is pow2-bucketed so warmup enumerates the
        # (Tk, W) verify set; the multi-step length k has its own ladder.
        # Both empty with the features off.
        self._verify_buckets = ([b for b in batch_buckets(cfg.draft_k + 1)
                                 if b >= 2] if cfg.speculative else [])
        self._ms_buckets = ([b for b in batch_buckets(cfg.multistep_k)
                             if b >= 2] if cfg.multistep_k >= 2 else [])
        # worst-case positions ONE iteration may write past ctx — block
        # growth reserves this span ahead (1 = classic single-token)
        self._iter_span = max(
            1, (cfg.draft_k + 1) if cfg.speculative else 1,
            cfg.multistep_k)
        self._draft = None
        if cfg.speculative and cfg.draft_mode == "model":
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "draft_mode='model' requires draft_params and "
                    "draft_cfg (a small transformer_lm_init model)")
            if int(draft_cfg.vocab) != int(model_cfg.vocab):
                raise ValueError(
                    f"draft model vocab {draft_cfg.vocab} != target "
                    f"vocab {model_cfg.vocab}")
        # the draft model proposes on the leader's host side: whole on its
        # device, never sharded, absent on a model-parallel follower
        if cfg.speculative and cfg.draft_mode == "model" \
                and self._programs.mp_rank == 0:
            from .speculative import DraftModel
            self._draft = DraftModel(
                draft_params, draft_cfg, cfg.draft_k,
                min(cfg.draft_window, int(draft_cfg.max_len)),
                compute_dtype=compute_dtype, device=self._device)

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._waiting: "deque[_GenRequest]" = deque()
        self._slots: List[Optional[_GenRequest]] = [None] * cfg.max_slots
        self._closed = False
        self._drain = True
        self._killed = False          # chaos hook: crashed-replica simulation
        self._next_rid = 0
        self._admit_seq = 0           # admission recency for victim order
        self._consec_step_failures = 0
        self._max_error_requeues = 3  # error-path requeue budget per request
        self._iteration = 0
        self._membership: "deque[Tuple[int, Tuple[int, ...]]]" = \
            deque(maxlen=4096)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._autostart = bool(start)
        self._follower_error: Optional[BaseException] = None
        if self._programs.mp_rank != 0:
            self._worker = threading.Thread(
                target=self._follow, name="tpumx-torch-generation-follower",
                daemon=True)
            self._worker.start()

        self._counts = {"submitted": 0, "finished": 0, "cancelled": 0,
                        "failed": 0, "rejected": 0, "expired": 0,
                        "shed": 0, "tokens": 0, "preempted": 0,
                        "requeued": 0, "quarantined": 0, "step_failures": 0,
                        "prefix_hits": 0, "prefix_misses": 0,
                        "prefix_evictions": 0, "cached_tokens": 0,
                        "prefill_tokens": 0, "cow_copies": 0,
                        "draft_proposed": 0, "draft_accepted": 0,
                        "spec_steps": 0, "multistep_steps": 0}
        self._peak_occupancy = 0.0
        self._ttft: "deque[float]" = deque(maxlen=4096)
        self._itl: "deque[float]" = deque(maxlen=4096)
        self._token_times: "deque[float]" = deque(maxlen=8192)

        reg = _obs.registry()
        self._g_running = reg.gauge("generation_running_requests")
        self._g_waiting = reg.gauge("generation_waiting_requests")
        self._g_blocks_used = reg.gauge("generation_kv_blocks_used")
        self._g_blocks_free = reg.gauge("generation_kv_blocks_free")
        self._g_occupancy = reg.gauge("generation_kv_block_occupancy")
        self._g_live_occupancy = reg.gauge(
            "generation_kv_block_live_occupancy",
            help="fraction of the pool holding WRITTEN context — the "
                 "number reserve-ahead reservation wastes and incremental "
                 "allocation recovers")
        self._g_tps = reg.gauge("generation_tokens_per_sec")
        self._c_tokens = reg.counter("generation_tokens_total")
        self._c_requests = reg.counter("generation_requests_total")
        self._c_preempt = reg.counter(
            "generation_preemptions_total",
            help="running requests preempted back to the waiting queue "
                 "by KV-pool pressure (watermark or failed growth)")
        self._c_requeue = reg.counter(
            "generation_requeues_total",
            help="requests requeued (not failed) after an iteration error "
                 "that never touched them")
        self._c_quarantine = reg.counter(
            "generation_quarantines_total",
            help="requests isolated by decode-step bisection and failed "
                 "with GenerationStepError")
        self._c_step_fail = reg.counter(
            "generation_step_failures_total",
            help="decode-step program invocations that raised")
        self._h_ttft = reg.histogram("generation_ttft_seconds")
        self._h_itl = reg.histogram("generation_inter_token_seconds")
        self._c_pc_hits = reg.counter(
            "generation_prefix_cache_hits_total",
            help="admissions whose prompt matched >= 1 cached full block "
                 "(prefill runs only the uncached suffix)")
        self._c_pc_misses = reg.counter(
            "generation_prefix_cache_misses_total",
            help="admissions that matched nothing in the prefix index")
        self._c_pc_evict = reg.counter(
            "generation_prefix_cache_evictions_total",
            help="cache-only blocks dropped from the prefix index "
                 "(LRU, ahead of victim preemption)")
        self._c_pc_tokens = reg.counter(
            "generation_prefix_cached_tokens_total",
            help="prompt tokens served from shared blocks instead of "
                 "being re-prefilled")
        self._g_blocks_shared = reg.gauge(
            "generation_kv_blocks_shared",
            help="pool blocks held by more than one owner "
                 "(BlockAllocator.num_shared) — the shared/exclusive "
                 "split of the occupancy gauges")
        self._g_pc_blocks = reg.gauge(
            "generation_prefix_cache_blocks",
            help="blocks currently resident in the prefix index")
        self._c_draft_proposed = reg.counter(
            "generation_draft_proposed_tokens_total",
            help="draft tokens proposed to the speculative verify step "
                 "(ngram prompt-lookup or the draft model)")
        self._c_draft_accepted = reg.counter(
            "generation_draft_accepted_tokens_total",
            help="proposed draft tokens the target model accepted "
                 "(emitted bitwise as its own tokens)")

    # -- submission ---------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_token: Optional[int] = "__config__",
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               timeout: Optional[float] = None,
               priority: int = 0,
               trace_ctx: Optional[_trace.TraceContext] = None
               ) -> GenerationStream:
        """Enqueue one generation request; returns a stream handle.

        ``prompt``: 1-D int token ids.  ``temperature <= 0`` is greedy;
        ``top_k``/``top_p`` follow :mod:`mxnet_tpu_torch.ops.sampling`.
        ``seed`` keys the request's private sampling randomness (its tokens
        are independent of which requests share its decode batch).
        ``deadline_ms`` bounds total queue+generate time.  ``on_token(rid,
        token)`` is called from the engine thread per token.  ``timeout``
        bounds a *blocking* submit under the ``block`` policy.
        ``priority`` is the request's class: higher classes are admitted
        first and preempted last (ties FIFO / newest-admitted-first).
        ``trace_ctx`` is the explicit trace handoff:
        the router passes its dispatch context so the request keeps ONE
        trace id across the replica hop; without it the submitting
        thread's context (or a fresh trace) is used.
        """
        cfg = self._config
        if not self.is_leader:
            raise MXNetError(
                f"GenerationService.submit: this process is rank "
                f"{self._programs.mp_rank} of a model-parallel service; "
                f"requests go to rank 0, which schedules for every rank")
        if self._closed:
            raise ServingClosedError("generation service is shut down")
        prompt = _np.asarray(prompt, dtype=_np.int64).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if _np.any(prompt < 0) or _np.any(prompt >= self._model_cfg.vocab):
            raise ValueError(
                f"prompt token ids must be in [0, {self._model_cfg.vocab})")
        # over-long prompts are rejected HERE (bucket_seq_len raises), the
        # enqueue-time contract the fixed-shape serving layer shares
        bucket = bucket_seq_len(prompt.size, self._seq_buckets)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else cfg.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.size) + max_new
        if total > self._model_cfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) = "
                f"{total} exceeds the model's max_len "
                f"{self._model_cfg.max_len}")
        need = blocks_for(total, cfg.block_size)
        if need > cfg.num_blocks - 1:
            raise ValueError(
                f"request needs {need} cache blocks but the pool only has "
                f"{cfg.num_blocks - 1} allocatable")
        # overload accounting with the prefix cache on: blocks the index
        # would serve are not new demand — charge only the projected
        # uncached suffix plus one block of copy-on-write slack
        charge = need
        if self._prefix is not None:
            cached_blocks = self._prefix.peek(prompt) // cfg.block_size
            if cached_blocks:
                charge = max(1, need - cached_blocks + 1)
        eos = cfg.eos_token if eos_token == "__config__" else (
            None if eos_token is None else int(eos_token))
        ms = deadline_ms if deadline_ms is not None \
            else cfg.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3

        budget = cfg.admission_budget * (cfg.num_blocks - 1)
        with self._lock:
            if self._closed:
                raise ServingClosedError("generation service is shut down")

            def _overloaded():
                # the token-budget estimator: worst-case projected blocks of everything
                # queued+running, plus this request — fires the policy
                # BEFORE the pool thrashes, not when the queue fills
                if len(self._waiting) >= cfg.queue_bound:
                    return f"generation queue bound {cfg.queue_bound} reached"
                projected = self._projected_blocks_locked() + charge
                if projected > budget:
                    return (f"projected KV demand {projected} blocks exceeds "
                            f"admission budget {budget:.0f} "
                            f"({cfg.admission_budget}x pool)")
                return None

            reason = _overloaded()
            if reason is not None:
                if cfg.backpressure == "reject":
                    self._counts["rejected"] += 1
                    raise QueueFullError(reason)
                if cfg.backpressure == "shed_oldest":
                    while self._waiting and _overloaded() is not None:
                        shed = self._waiting.popleft()
                        self._counts["shed"] += 1
                        self._finish_locked(shed, error=RequestShedError(
                            "request shed under overload (shed_oldest): "
                            + reason))
                else:  # block
                    t_end = (None if timeout is None
                             else time.perf_counter() + timeout)
                    while _overloaded() is not None and not self._closed:
                        remaining = (None if t_end is None
                                     else t_end - time.perf_counter())
                        if remaining is not None and remaining <= 0:
                            raise QueueFullError(
                                f"blocking submit timed out after {timeout}s")
                        self._not_full.wait(remaining)
                    if self._closed:
                        raise ServingClosedError(
                            "generation service is shut down")
            req = _GenRequest(self._next_rid, prompt.astype(_np.int32),
                              bucket, max_new, temperature, top_k, top_p,
                              seed, eos, deadline, on_token,
                              priority=priority)
            req.charged_blocks = charge
            if _trace.enabled():
                req.trace = (trace_ctx or _trace.current_trace()
                             or _trace.new_trace())
            self._next_rid += 1
            self._waiting.append(req)
            self._counts["submitted"] += 1
            self._c_requests.inc()
            self._g_waiting.set(len(self._waiting))
            self._not_empty.notify_all()
        if self._autostart:
            self._ensure_worker()
        return GenerationStream(req, self)

    def generate(self, prompt, **kwargs) -> List[int]:
        """Blocking convenience wrapper: ``submit(...).result()``."""
        timeout = kwargs.pop("timeout", None)
        return self.submit(prompt, **kwargs).result(timeout)

    # -- lifecycle ----------------------------------------------------------------
    def start(self) -> None:
        """Launch the engine loop (idempotent)."""
        self._autostart = True
        self._ensure_worker()

    @property
    def is_leader(self) -> bool:
        """True unless this process is a model-parallel follower."""
        return self._programs.mp_rank == 0

    def _follow(self) -> None:
        try:
            self._programs.follow(self._cache)
        except BaseException as e:  # noqa: BLE001 — raised by stop()
            self._follower_error = e

    def _ensure_worker(self) -> None:
        if self._killed or not self.is_leader:
            return  # a crashed replica never restarts itself
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                t = threading.Thread(target=self._loop,
                                     name="tpumx-torch-generation-engine",
                                     daemon=True)
                self._worker = t
                t.start()

    def warmup(self) -> int:
        """Run the entire steady-state step set once — one prefill per
        (T, W) signature the chunk planner can emit, one decode per
        block-table-width bucket, with speculative decoding every (Tk, W)
        verify step and the draft proposer, with multi-step decoding every
        (k, W) program (captured as a CUDA graph on the card), and the
        copy-on-write block copy when the prefix cache is on — so first
        requests pay no set-up.  All rows are inactive (length 0): the
        steps write only the null block.  Calls
        ``observability.mark_warm()`` — with ``TPUMX_FREEZE_COMPILES=1``
        any later new signature raises.  Returns the number of new
        signatures."""
        cfg = self._config
        if not self.is_leader:
            return 0  # the leader's warmup runs every step here too
        before = self._programs.compiled_signatures()
        S = cfg.max_slots
        zeros_s = _np.zeros(S, _np.int32)
        with _obs.span("serving.warmup", cat="serving"):
            # every (T, W) pair the chunk planner can emit — the plain
            # per-rung ladder when chunked prefill is off
            for tb, wp in self._prefill_signatures():
                self._programs.run(
                    "gen_prefill", self._cache,
                    _np.zeros((1, tb), _np.int32),
                    _np.zeros((1, tb), _np.int32), _np.zeros(1, _np.int32),
                    _np.zeros((1, wp), _np.int32),
                    _np.zeros(1, _np.uint32), _np.zeros(1, _np.uint32),
                    _np.zeros(1, _np.float32), _np.zeros(1, _np.int32),
                    _np.ones(1, _np.float32))
            for w in self._width_buckets:
                self._programs.run(
                    "gen_decode", self._cache,
                    _np.zeros((S, 1), _np.int32),
                    _np.zeros((S, 1), _np.int32), zeros_s,
                    _np.zeros((S, w), _np.int32),
                    zeros_s.astype(_np.uint32), zeros_s.astype(_np.uint32),
                    zeros_s.astype(_np.float32), zeros_s,
                    _np.ones(S, _np.float32))
            # speculative verify: every (Tk, W) pair on the ladders
            for tk in self._verify_buckets:
                for w in self._width_buckets:
                    self._programs.run_verify(
                        self._cache,
                        _np.zeros((S, tk), _np.int32),
                        _np.zeros((S, tk), _np.int32), zeros_s,
                        _np.zeros((S, w), _np.int32),
                        zeros_s.astype(_np.uint32),
                        zeros_s.astype(_np.uint32),
                        zeros_s.astype(_np.float32), zeros_s,
                        _np.ones(S, _np.float32))
            # multi-step: one program (one CUDA graph) per (k, W)
            for k in self._ms_buckets:
                for w in self._width_buckets:
                    self._programs.run_multistep(
                        k, self._cache, zeros_s, zeros_s, zeros_s,
                        _np.zeros((S, w), _np.int32),
                        zeros_s.astype(_np.uint32),
                        zeros_s.astype(_np.uint32),
                        zeros_s.astype(_np.float32), zeros_s,
                        _np.ones(S, _np.float32))
            if self._draft is not None:
                # the draft proposer is ONE (S, window, k) signature
                self._draft.propose(
                    _np.zeros((S, self._draft.window), _np.int32),
                    _np.zeros((S, self._draft.window), _np.int32),
                    zeros_s)
            if self._prefix is not None:
                # copying the reserved null block onto itself warms the
                # copy without touching real cache state
                self._programs.copy_block(self._cache, 0, 0)
        _obs.mark_warm()
        return self._programs.compiled_signatures() - before

    def stop(self, drain: bool = True, timeout: Optional[float] = None,
             reject_queued: bool = False) -> None:
        """Shut down.  ``drain=True`` finishes running AND queued requests
        first; ``drain=False`` fails them with ServingClosedError.
        ``reject_queued=True`` (with ``drain=True``) is the graceful
        PREEMPTION mode: requests already decoding in slots run to
        completion, WAITING ones are rejected with a clear shutdown error
        — bounded work without abandoning accepted streams.  A
        model-parallel leader then tells its followers to stop; a
        follower waits (up to ``timeout``) for that and raises the
        failure that ended its loop, if one did."""
        if not self.is_leader:
            self._worker.join(timeout)
            self._closed = True
            if self._follower_error is not None:
                raise MXNetError(
                    f"model-parallel follower rank "
                    f"{self._programs.mp_rank} failed: "
                    f"{self._follower_error!r}") from self._follower_error
            if self._worker.is_alive():
                raise MXNetError(
                    f"model-parallel follower rank {self._programs.mp_rank}"
                    f": rank 0 did not stop within {timeout} s")
            return
        started = self._worker is not None and self._worker.is_alive()
        with self._lock:
            self._closed = True
            self._drain = drain
            if reject_queued or not started:
                # rejected-at-queue (preemption) or no loop to hand them to
                while self._waiting:
                    self._finish_locked(self._waiting.popleft(),
                                        error=ServingClosedError(
                                            "generation service shutting "
                                            "down; queued request rejected"))
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if started:
            self._worker.join(timeout)
        self._programs.close()
        if self._prefix is not None:
            # release the cache's own block references (blocks still held
            # by live requests merely lose their shared status)
            self._prefix.drop_all()
        self.uninstall_signal_handlers()

    drain_and_stop = stop

    def kill(self) -> None:
        """Chaos/test hook: simulate a crashed replica.  The engine loop exits at its next iteration WITHOUT
        draining, failing, or notifying outstanding requests — their
        streams hang exactly as they would if the process died.  The
        router's health probe is the layer that must notice and recover
        (``TPUMX_FAULT_GEN_KILL_REPLICA`` drives this deterministically)."""
        self._killed = True
        with self._lock:
            self._not_empty.notify_all()

    def health(self) -> dict:
        """Liveness/health snapshot for the router's probe loop."""
        worker_ok = self._worker is None or self._worker.is_alive()
        with self._lock:
            waiting = len(self._waiting)
            running = sum(1 for r in self._slots if r is not None)
        return {
            "alive": (not self._killed) and (not self._closed) and worker_ok,
            "replica": self._replica_id,
            "killed": self._killed,
            "closed": self._closed,
            "consecutive_step_failures": self._consec_step_failures,
            "waiting": waiting,
            "running": running,
            "occupancy": self._cache.allocator.occupancy(),
        }

    def load(self) -> float:
        """Dispatch-ranking load score: queue depth + running slots +
        KV occupancy — the same signals the observability gauges export
        (the router's least-loaded policy sorts on this)."""
        with self._lock:
            waiting = len(self._waiting)
            running = sum(1 for r in self._slots if r is not None)
        return waiting + running + self._cache.allocator.occupancy()

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Graceful preemption shutdown: slots finish their generations,
        queued requests are rejected."""
        _obs.registry().counter(
            "serving_graceful_shutdowns_total",
            help="graceful (signal-driven) service shutdowns").inc()
        self.stop(drain=True, timeout=timeout, reject_queued=True)

    def install_signal_handlers(self, signals=None) -> bool:
        """Drain on SIGTERM/SIGINT through the process-wide hub
        (:mod:`mxnet_tpu_torch.fault.preemption`).  Returns False off the
        main thread."""
        from ...fault.preemption import (DEFAULT_SIGNALS,
                                         install_shutdown_hook)

        if getattr(self, "_signal_unregister", None) is not None:
            return True
        _flight.install()  # a preempted replica leaves its black box
        self._signal_unregister = install_shutdown_hook(
            lambda signum: self.shutdown(),
            signals or DEFAULT_SIGNALS)
        return self._signal_unregister is not None

    def uninstall_signal_handlers(self) -> None:
        unreg = getattr(self, "_signal_unregister", None)
        if unreg is not None:
            self._signal_unregister = None
            unreg()
            # symmetric lifecycle: the hub restores default dispositions
            # once its last callback unregisters (a mid-delivery dump
            # still fires — the hub iterates a snapshot)
            _flight.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- the engine loop ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            admitted: List[_GenRequest] = []
            with self._lock:
                if self._killed:
                    return  # crashed-replica simulation: vanish, no cleanup
                if self._programs.broken is not None:
                    # a model-parallel peer failed: no step can run again
                    err = ServingError(
                        f"model-parallel group failed: "
                        f"{self._programs.broken!r}")
                    while self._waiting:
                        self._finish_locked(self._waiting.popleft(),
                                            error=err)
                    for i, r in enumerate(self._slots):
                        if r is not None:
                            self._release_slot_locked(i, error=err)
                    self._closed = True
                    self._update_gauges_locked()
                    return
                self._purge_waiting_locked()
                self._evict_locked()
                if self._closed and not self._drain:
                    err = ServingClosedError("generation service shut down")
                    for r in list(self._waiting):
                        self._finish_locked(r, error=err)
                    self._waiting.clear()
                    for i, r in enumerate(self._slots):
                        if r is not None:
                            self._release_slot_locked(i, error=err)
                    self._update_gauges_locked()
                    return
                if self._config.preemption:
                    self._watermark_preempt_locked()
                    self._grow_blocks_locked()
                admitted = self._admit_locked()
                active = [r for r in self._slots if r is not None]
                if not active and not admitted:
                    if self._closed and not self._waiting:
                        return
                    self._update_gauges_locked()
                    self._not_empty.wait(0.05)
                    continue
                # per-iteration progress snapshot: the blast-radius guard
                # distinguishes requests the failing step advanced from
                # untouched ones (the latter are requeued, never failed)
                progress = {r.rid: r.n_generated
                            for r in self._slots if r is not None}
            try:
                for req in admitted:
                    try:
                        self._prefill(req)
                    except Exception as exc:  # noqa: BLE001 — isolate
                        self._requeue_or_fail(req, exc)
                running = [r for r in self._slots
                           if r is not None and r.state == _RUNNING]
                self._membership.append(
                    (self._iteration,
                     tuple(sorted(r.rid for r in running))))
                if running:
                    self._decode_isolated(running)
            except Exception as exc:  # noqa: BLE001 — the loop must survive
                # any per-iteration surprise with minimum blast radius:
                # requeue what the failing iteration never touched
                self._absorb_iteration_error(exc, progress)
            self._iteration += 1
            with self._lock:
                self._update_gauges_locked()

    # -- scheduling (all _locked helpers hold self._lock) -------------------------
    def _purge_waiting_locked(self) -> None:
        now = time.perf_counter()
        keep: "deque[_GenRequest]" = deque()
        for r in self._waiting:
            if r.cancel_requested:
                self._counts["cancelled"] += 1
                self._finish_locked(r, reason=_CANCELLED)
            elif r.expired(now):
                self._counts["expired"] += 1
                self._finish_locked(r, error=DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - r.t_submit) * 1e3:.1f}ms in queue"))
            else:
                keep.append(r)
        if len(keep) != len(self._waiting):
            self._waiting = keep
            self._not_full.notify_all()

    def _evict_locked(self) -> None:
        now = time.perf_counter()
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            if r.cancel_requested and r.state == _RUNNING:
                self._counts["cancelled"] += 1
                self._release_slot_locked(i, reason=_CANCELLED)
            elif r.state in (_FINISHED, _FAILED, _CANCELLED):
                self._release_slot_locked(i)
            elif r.expired(now):
                self._counts["expired"] += 1
                self._release_slot_locked(i, error=DeadlineExceededError(
                    f"deadline exceeded after {r.n_generated} tokens"))

    def _admit_need(self, r: _GenRequest) -> int:
        """Blocks an admission must secure for ``r``: under incremental
        allocation the current context plus the span the first decode
        iteration may write (``_iter_span``: 1 position for single-token
        decode, up to ``draft_k + 1`` or ``multistep_k`` for the
        multi-token steps, which run in the admission's own iteration
        before the next growth pass); under reserve-ahead the full worst
        case.  (The reference secures ``ctx + 1`` also for multi-token
        steps, so their first iteration after admission writes past the
        row's table into the null block.)"""
        cfg = self._config
        if cfg.preemption:
            ctx = r.ctx_len if r.ctx_len > 0 else r.prompt_len
            return blocks_for(min(ctx + self._iter_span,
                                  r.prompt_len + r.max_new), cfg.block_size)
        return blocks_for(r.prompt_len + r.max_new, cfg.block_size)

    def _admit_locked(self) -> List[_GenRequest]:
        """Priority-class-then-FIFO admission: fill free slots while the
        best waiting request's block need fits (head-of-line blocking
        within the chosen class is the deliberate fairness policy).  Under incremental allocation, admission
        additionally leaves the high-watermark headroom intact unless
        nothing is running at all (the progress guarantee)."""
        cfg = self._config
        alloc = self._cache.allocator
        total = cfg.num_blocks - 1
        admitted = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._waiting:
            best_i, head = 0, self._waiting[0]
            for j, r in enumerate(self._waiting):
                if r.priority > head.priority:
                    best_i, head = j, r
            need = self._admit_need(head)
            # prefix cache: take shared references on
            # the longest cached full-block prefix; only the uncached
            # remainder is new allocation
            shared: List[int] = []
            cached = 0
            if self._prefix is not None:
                ctx = head.ctx_len if head.ctx_len > 0 else head.prompt_len
                shared, cached = self._prefix.acquire(head.seq_tokens[:ctx])
            grow = need - len(shared)
            if cfg.preemption and any(s is not None for s in self._slots) \
                    and alloc.num_used + grow > cfg.watermark_high * total:
                # cache-only blocks are reclaimable headroom: evict before
                # concluding the pool is too full to admit
                over = alloc.num_used + grow - cfg.watermark_high * total
                if self._prefix is not None and over > 0:
                    self._prefix.evict_blocks(int(over) + 1)
                if alloc.num_used + grow > cfg.watermark_high * total:
                    if shared:
                        alloc.decref(shared)
                    break  # keep the growth headroom; readmit later
            blocks = self._alloc_reclaiming(grow)
            if blocks is None:
                if shared:
                    alloc.decref(shared)
                break
            del self._waiting[best_i]
            head.blocks = shared + blocks
            head.cached_len = cached
            head.cached_total += cached
            if self._prefix is not None:
                if cached:
                    self._counts["prefix_hits"] += 1
                    self._counts["cached_tokens"] += cached
                    self._c_pc_hits.inc()
                    self._c_pc_tokens.inc(cached)
                else:
                    self._counts["prefix_misses"] += 1
                    self._c_pc_misses.inc()
            head.state = _RUNNING
            head.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._slots[free.pop(0)] = head
            admitted.append(head)
            # latency attribution: close the wait segment (queue on first
            # admission, preempted on re-admission) and record it as a
            # span of the request's trace — the engine thread picks up
            # the context the submitter parked on the request
            now = time.perf_counter()
            waited, t_wait0 = head.seg_state, head.seg_t0
            head.seg("admission", now)
            if head.trace is not None:
                _trace.record_event(
                    "gen.queue", "serving", t_wait0, now, ctx=head.trace,
                    args={"rid": head.rid, "kind": waited,
                          "replica": self._replica_id})
            self._not_full.notify_all()
        return admitted

    def _alloc_reclaiming(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, reclaiming cache-only prefix blocks
        (LRU) when the free list alone cannot cover it — the cache yields
        to live demand BEFORE any running request is preempted.  Safe
        with or without the service lock: allocator and index carry their
        own locks."""
        alloc = self._cache.allocator
        got = alloc.allocate(n)
        if got is None and self._prefix is not None:
            self._prefix.evict_blocks(int(n) - alloc.num_free)
            got = alloc.allocate(n)
        return got

    def _cow_for_write(self, r: _GenRequest, off: int, take: int) -> None:
        """Copy-on-write: before a
        scatter into positions ``[off, off + take)``, any target block
        with ``refcount > 1`` (shared prompt history) is replaced by a
        private copy — writers never touch shared blocks, and
        sharers' logits are bit-identical before and after the append.
        Runs on the engine thread with no service lock held."""
        if self._prefix is None or take <= 0:
            return
        bs = self._config.block_size
        alloc = self._cache.allocator
        for li in range(off // bs, (off + take - 1) // bs + 1):
            if li >= len(r.blocks):
                break
            b = r.blocks[li]
            if alloc.refcount(b) <= 1:
                continue
            fresh = self._alloc_reclaiming(1)
            if fresh is None:
                raise ServingError(
                    f"KV pool exhausted allocating a copy-on-write block "
                    f"for request {r.rid} (shared block {b})")
            with _obs.span("serving.cow_copy", cat="serving",
                           args={"rid": r.rid, "src": int(b),
                                 "dst": int(fresh[0])}, ctx=r.trace):
                self._programs.copy_block(self._cache, b, fresh[0])
            r.blocks[li] = fresh[0]
            alloc.decref([b])
            r.cow_copies += 1
            self._counts["cow_copies"] += 1

    def _index_safe_ctx(self, r: _GenRequest) -> int:
        """Longest context prefix whose cache bits are safe to share via
        the prefix index.  f32/bf16 pools: the whole context (rejected
        speculative writes only ever land at positions >= ctx_len, never
        inside an indexed full block).  int8 pools: capped at
        ``index_safe_len`` once a partial-rejection verify requantized a
        mixed accepted/rejected boundary block under a transiently larger
        scale."""
        if r.index_safe_len is None:
            return r.ctx_len
        return min(r.ctx_len, r.index_safe_len)

    def _pick_victim_locked(self) -> Optional[int]:
        """Victim slot for preemption: lowest priority class first, then
        newest admitted (vLLM's evict-the-latecomer policy — the oldest
        request monotonically progresses, guaranteeing liveness)."""
        best_i = None
        best_key = None
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING:
                continue
            key = (r.priority, -r.admit_seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def _preempt_slot_locked(self, i: int, counter: str = "preempted") -> None:
        """Move a running request back to the waiting queue: blocks
        returned to the pool, context retained — re-admission re-prefills
        it through the chunked-prefill rungs (tokens stay bit-identical:
        sampling is keyed on (seed, position) only)."""
        r = self._slots[i]
        r.seg("preempted", time.perf_counter())
        with _obs.span("serving.preempt", cat="serving",
                       args={"rid": r.rid, "ctx": r.ctx_len,
                             "blocks": len(r.blocks or ()),
                             "kind": counter}, ctx=r.trace):
            self._slots[i] = None
            if r.blocks:
                # a preempted request's written context is valid history:
                # index its full blocks so the decref below leaves them
                # RESIDENT (cache-held) and the re-prefill on re-admission
                # re-hits them — resumed TTFT collapses too.  The error-
                # requeue path ("requeued") skips this: a failing step may
                # have left the blocks suspect.
                if self._prefix is not None and counter == "preempted" \
                        and self._index_safe_ctx(r) > 0:
                    self._prefix.insert(
                        r.seq_tokens[:self._index_safe_ctx(r)], r.blocks)
                self._cache.allocator.free(r.blocks)
                r.blocks = None
            r.state = _WAITING
            self._waiting.appendleft(r)
            if counter == "preempted":
                r.n_preempted += 1
                self._c_preempt.inc()
            else:
                r.n_requeues += 1
                self._c_requeue.inc()
            self._counts[counter] += 1

    def _watermark_preempt_locked(self) -> None:
        """Crossing the high watermark preempts victims down to the low
        watermark, so near-term block growth never hits a hard exhaust
        mid-step.  The last running request is never preempted (it alone
        cannot thrash the pool — its worst case was validated at submit)."""
        alloc = self._cache.allocator
        if not alloc.above_high():
            return
        # cache-only blocks go first: LRU eviction of index-held blocks ahead of victim
        # preemption — dropping reusable history is strictly cheaper than
        # re-prefilling a live request
        if self._prefix is not None:
            while alloc.above_low() and self._prefix.evict_blocks(1):
                pass
            if not alloc.above_high():
                return
        while alloc.above_low():
            if sum(1 for r in self._slots
                   if r is not None and r.state == _RUNNING) <= 1:
                break
            v = self._pick_victim_locked()
            if v is None:
                break
            self._preempt_slot_locked(v)

    def _grow_blocks_locked(self) -> None:
        """Incremental allocation: before the decode step, every running
        request whose next written position crosses a block boundary gets
        one more block — oldest admitted first.  Exhaustion preempts the
        victim policy's pick; when the grower IS the pick, it preempts
        itself (it is the newest/lowest — latecomers yield)."""
        cfg = self._config
        order = sorted(
            (i for i, r in enumerate(self._slots)
             if r is not None and r.state == _RUNNING),
            key=lambda i: self._slots[i].admit_seq)
        for i in order:
            r = self._slots[i]
            if r is None or r.state != _RUNNING:
                continue  # preempted by an earlier grower this pass
            # reserve the whole iteration's worst-case write span (the
            # verify chunk / multistep scan may append up to _iter_span
            # positions); span 1 == the classic next-position arithmetic,
            # and the cap at prompt+max_new means single-token services
            # are byte-identical
            need = blocks_for(
                min(r.ctx_len + self._iter_span,
                    r.prompt_len + r.max_new), cfg.block_size)
            while len(r.blocks) < need:
                got = self._alloc_reclaiming(need - len(r.blocks))
                if got is not None:
                    r.blocks.extend(got)
                    break
                v = self._pick_victim_locked()
                if v is None or self._slots[v] is r:
                    self._preempt_slot_locked(i)
                    break
                self._preempt_slot_locked(v)

    def _projected_blocks_locked(self) -> int:
        """Worst-case KV demand of everything queued + running — the
        overload estimator's input.  With the prefix
        cache on, each request carries its submit-time charge: worst case
        minus the blocks the index projected to serve, plus CoW slack —
        a shared-prompt burst no longer rejects on demand the pool never
        actually sees.  Cache off: charge == the full worst case."""
        bs = self._config.block_size
        total = 0
        for r in self._waiting:
            total += (r.charged_blocks
                      or blocks_for(r.prompt_len + r.max_new, bs))
        for r in self._slots:
            if r is not None:
                total += (r.charged_blocks
                          or blocks_for(r.prompt_len + r.max_new, bs))
        return total

    def _release_slot_locked(self, i: int, reason: str = _FINISHED,
                             error: Optional[BaseException] = None) -> None:
        r = self._slots[i]
        self._slots[i] = None
        if r.blocks:
            # keep a finished request's full blocks resident for the next
            # shared-prompt arrival (only clean completions: an errored
            # request's cache state is suspect)
            if self._prefix is not None and reason == _FINISHED \
                    and error is None and self._index_safe_ctx(r) > 0:
                self._prefix.insert(
                    r.seq_tokens[:self._index_safe_ctx(r)], r.blocks)
            self._cache.allocator.free(r.blocks)
            r.blocks = None
        self._finish_locked(r, reason=reason, error=error)
        self._not_full.notify_all()  # blocks freed: budget waiters re-check

    def _finish_locked(self, r: _GenRequest, reason: str = _FINISHED,
                       error: Optional[BaseException] = None) -> None:
        if r.done_event.is_set():
            return
        now = time.perf_counter()
        r.seg("end", now)  # close the final lifetime segment
        if error is not None:
            r.state = _FAILED
            r.finish_reason = r.finish_reason or "error"
            r.error = error
            self._counts["failed"] += 1
            r.out_queue.put(("error", error))
        else:
            r.state = reason
            r.finish_reason = r.finish_reason or reason
            r.out_queue.put(("done", r.finish_reason))
        # every request terminates in ONE wide-event record: ring + TPUMX_TRACE_LOG sink + stream
        # stats, and the trace gains its terminal reply span
        r.wide_event = self._build_wide_event(r, now)
        _trace.record_wide_event(r.wide_event)
        if r.trace is not None:
            _trace.record_event("gen.reply", "serving", now,
                                time.perf_counter(), ctx=r.trace,
                                args={"rid": r.rid, "outcome": r.state,
                                      "replica": self._replica_id})
        r.done_event.set()

    def _build_wide_event(self, r: _GenRequest, now: float) -> dict:
        bd = dict(r.breakdown)
        bd.pop("end", None)
        first = r.breakdown_first
        return {
            "type": "generation_request",
            "request_id": r.rid,
            "trace_id": None if r.trace is None else r.trace.trace_id,
            "replica": self._replica_id,
            "priority": r.priority,
            "prompt_tokens": r.prompt_len,
            "output_tokens": r.n_generated,
            "outcome": r.state,
            "finish_reason": r.finish_reason,
            "error": None if r.error is None else repr(r.error),
            "total_ms": round((now - r.t_submit) * 1e3, 3),
            "ttft_ms": (None if r.t_first is None
                        else round((r.t_first - r.t_submit) * 1e3, 3)),
            "ttft_breakdown_ms": (
                None if first is None
                else {k: round(v * 1e3, 3) for k, v in first.items()}),
            "breakdown_ms": {k: round(v * 1e3, 3) for k, v in bd.items()},
            "prefill_rungs_ms": {str(k): round(v * 1e3, 3)
                                 for k, v in r.rung_s.items()},
            "decode_steps": r.decode_steps,
            "preemptions": r.n_preempted,
            "requeues": r.n_requeues,
            "retries": r.n_retries,
            "prefix_cached_tokens": r.cached_total,
            "cow_copies": r.cow_copies,
            "decode_mode": _dominant_mode(r.mode_tokens),
            "accepted_ratio": (None if r.draft_proposed == 0 else
                               round(r.draft_accepted / r.draft_proposed,
                                     4)),
            "draft_proposed_tokens": r.draft_proposed,
            "draft_accepted_tokens": r.draft_accepted,
            "token_offsets_ms": [round((t - r.t_submit) * 1e3, 3)
                                 for t in r.token_log],
        }

    # -- model steps (engine thread, no lock held) --------------------------------
    def _rung_step(self, off: int, rem: int):
        """The next greedy chunk at position ``off`` with ``rem`` positions
        left: ``(off, take, T, W)``, T the largest rung that fits (else the
        smallest), the table width pow2-bucketed on the decode width
        ladder so the (T, W) signature set stays finite."""
        fitting = [b for b in self._seq_buckets if b <= rem]
        tb = fitting[-1] if fitting else self._seq_buckets[0]
        w = bucket_batch(blocks_for(off + tb, self._config.block_size),
                         self._width_buckets)
        return (off, min(rem, tb), tb, w)

    def _rung_walk(self, off: int, end: int):
        """Greedy rung-sized chunks covering positions ``[off, end)``."""
        chunks = []
        while off < end:
            chunks.append(self._rung_step(off, end - off))
            off += chunks[-1][1]
        return chunks

    def _chunk_plan(self, prompt_len: int, force_chunked: bool = False,
                    start: int = 0):
        """Prefill chunking: ``[(off, take, T, W)]``.

        A single entry is the whole prompt padded to its ladder rung, table
        width ``blocks_for(rung)``.  With chunked prefill on and a prompt
        past the smallest rung, the prompt is split greedily into
        rung-sized chunks fed through the same cache-aware prefill step
        (each chunk writes its positions and attends to everything already
        cached).

        ``force_chunked`` is the re-prefill spelling: a preempted request's
        context can exceed the prompt ladder and must chunk even with
        chunked prefill off.  ``start`` is the prefix-cache spelling:
        positions ``[0, start)`` are already resident in shared blocks, so
        the walk covers only the uncached suffix, on the same ladder."""
        cfg = self._config
        rungs = self._seq_buckets
        if start > 0:
            return self._rung_walk(start, prompt_len)
        chunked = cfg.chunked_prefill or force_chunked
        if chunked and prompt_len > rungs[0]:
            chunks = self._rung_walk(0, prompt_len)
            if len(chunks) > 1:
                return chunks
        # one rung: the unchunked plan
        tb = bucket_seq_len(prompt_len, rungs)
        return [(0, prompt_len, tb, blocks_for(tb, cfg.block_size))]

    def _prefill_signatures(self):
        """Every (T, W) prefill signature the chunk planner can emit — the
        warmup set (one pass over the possible lengths): fresh prompts,
        with preemption every re-prefill of a context up to ``max_len -
        1``, and with the prefix cache every cache-hit suffix walk plus the
        fully-cached single-position recompute."""
        cfg = self._config
        bs = cfg.block_size
        out = {(tb, blocks_for(tb, bs)) for tb in self._seq_buckets}
        if cfg.chunked_prefill:
            for L in range(1, self._seq_buckets[-1] + 1):
                for (_, _, tb, w) in self._chunk_plan(L):
                    out.add((tb, w))
        if cfg.preemption:
            for L in range(1, self._model_cfg.max_len):
                for (_, _, tb, w) in self._chunk_plan(L, force_chunked=True):
                    out.add((tb, w))
        if cfg.prefix_cache:
            # the rung walk from every block-aligned cached length to
            # every context length, memoized on (off, remaining)
            max_ctx = self._model_cfg.max_len - 1
            seen = set()
            for start in range(bs, max_ctx, bs):
                for ctx in range(start + 1, max_ctx + 1):
                    off, rem = start, ctx - start
                    while rem > 0 and (off, rem) not in seen:
                        seen.add((off, rem))
                        _, take, tb, w = self._rung_step(off, rem)
                        out.add((tb, w))
                        off += take
                        rem -= take
            # fully cached prompts: the single-position logit recompute at
            # position p-1 (only block-aligned prompt lengths can be fully
            # cached, and fresh prompts are bounded by the ladder)
            tb0 = self._seq_buckets[0]
            for p in range(bs, self._seq_buckets[-1] + 1, bs):
                out.add((tb0, bucket_batch(blocks_for(p - 1 + tb0, bs),
                                           self._width_buckets)))
        return sorted(out)

    def _prefill(self, r: _GenRequest) -> None:
        cfg = self._config
        next_tok = None
        # re-admission after preemption: replay the WHOLE cached context
        # (prompt + already-generated tokens) through the chunked-prefill
        # rungs, emit nothing — the pending token at index ctx_len is
        # already in seq_tokens and the next decode picks it up.  The
        # final chunk's sample (seed, counter=ctx) is bit-identical to the
        # token already emitted, so it is simply discarded.
        resumed = r.ctx_len > 0
        ctx = r.ctx_len if resumed else r.prompt_len
        cached = min(r.cached_len, ctx)
        if cached >= ctx and resumed:
            # full re-hit: the whole written context (prompt + generated)
            # is already resident in shared blocks — nothing to compute;
            # the pending token at index ctx is in seq_tokens and the next
            # decode picks it up
            plan = []
        elif cached >= ctx:
            # whole prompt cached: recompute only the last position, for
            # its logits; its scatter lands in the shared tail block, which
            # _cow_for_write copies first (an int8 copy requantizes bit-
            # stably, so the block and the sampled token match a miss)
            start = ctx - 1
            tb0 = self._seq_buckets[0]
            plan = [(start, 1, tb0,
                     bucket_batch(blocks_for(start + tb0, cfg.block_size),
                                  self._width_buckets))]
        elif cached > 0:
            # uncached suffix only, through the SAME (T, W) rung ladder
            plan = self._chunk_plan(ctx, start=cached)
        else:
            plan = self._chunk_plan(ctx, force_chunked=resumed)
        # attribution: the admission segment ran from block allocation to
        # here; record it on the trace, then open the prefill segment —
        # with a prefix_reuse segment between them when the cache served
        # part of the context (the partition stays exact)
        now = time.perf_counter()
        if r.trace is not None:
            _trace.record_event("gen.admit", "serving", r.seg_t0, now,
                                ctx=r.trace,
                                args={"rid": r.rid, "resumed": resumed,
                                      "blocks": len(r.blocks or ()),
                                      "cached": cached,
                                      "replica": self._replica_id})
        if cached > 0:
            r.seg("prefix_reuse", now)
            now = time.perf_counter()
        r.seg("prefill", now)
        for (off, take, tb, wp) in plan:
            self._cow_for_write(r, off, take)
            table = _np.zeros((1, wp), _np.int32)
            n = min(wp, len(r.blocks))
            table[0, :n] = r.blocks[:n]
            tokens = pad_tokens_right(
                _np.asarray(r.seq_tokens[off:off + take], _np.int32),
                tb)[None, :]
            positions = _np.arange(off, off + tb, dtype=_np.int32)[None, :]
            t_rung0 = time.perf_counter()
            with _obs.span("serving.prefill", cat="serving",
                           args={"rid": r.rid, "len": ctx,
                                 "bucket": tb, "off": off,
                                 "chunks": len(plan),
                                 "resumed": resumed}, ctx=r.trace):
                # the sampler reads the chunk's last VALID row; only the
                # final chunk's sample (global position prompt_len-1, the
                # same seed/counter as the unchunked program) is emitted —
                # intermediate chunks exist to fill the cache
                next_tok, _ = self._programs.run(
                    "gen_prefill", self._cache, tokens, positions,
                    _np.asarray([take], _np.int32), table,
                    _np.asarray([r.seed], _np.uint32),
                    _np.asarray([ctx], _np.uint32),
                    _np.asarray([r.temperature], _np.float32),
                    _np.asarray([r.top_k], _np.int32),
                    _np.asarray([r.top_p], _np.float32))
            r.rung_s[tb] = r.rung_s.get(tb, 0.0) \
                + (time.perf_counter() - t_rung0)
        self._counts["prefill_tokens"] += sum(p[1] for p in plan)
        r.seg("decode", time.perf_counter())
        # make this context's full blocks available to the NEXT shared-
        # prompt arrival immediately (not only at finish): concurrent
        # identical prompts then hit while the first is still decoding
        if self._prefix is not None and not resumed:
            self._prefix.insert(r.seq_tokens[:ctx], r.blocks)
        if resumed:
            return
        r.ctx_len = r.prompt_len
        self._emit_token(r, int(next_tok[0]))

    def _decode_step(self, batch: List[_GenRequest]) -> None:
        """One decode iteration over exactly the requests in ``batch``
        (slots outside it stay inactive: length 0, null-block table) —
        the full running set normally, a bisection subset when isolating
        a poisoned request.  Tokens are batch-composition-independent
        (seeded per request), so subsets emit identical values.

        Mode dispatch: with
        speculative decoding on and at least one slot holding draft
        proposals, the iteration is ONE multi-query verify step (slots
        without drafts ride along at chunk length 1); otherwise, when
        multistep is enabled and the adaptive policy allows, k decode
        iterations run in one dispatch; otherwise the classic
        single-token step.  All three paths emit identical token VALUES —
        they differ only in how many tokens one device dispatch yields."""
        cfg = self._config
        if cfg.speculative:
            drafts = self._propose_drafts(batch)
            if any(drafts.values()):
                self._spec_step(batch, drafts)
                return
        k = self._choose_multistep_k(batch)
        if k >= 2:
            self._multistep_step(batch, k)
            return
        self._single_step(batch)

    def _batch_operands(self, rids, tk: int = 1,
                        drafts: Optional[Dict[int, List[int]]] = None,
                        span: int = 1):
        """The operands of one decode step over the running slots whose
        request is in ``rids``: per row its pending token, then its
        ``drafts`` (rid -> tokens), in ``tk`` columns at positions
        ``ctx_len + j``; the sampler's per-row settings, with the counter
        of the first token produced; and block tables wide enough for the
        ``span`` positions the step writes (at least those fed).  Raises
        the injected step failure (``TPUMX_FAULT_GEN_STEP_FAIL``) before
        anything is dispatched, so the paged pool is never half-written.
        Returns (tokens, positions, lengths, tables, seeds, counters,
        temperature, top_k, top_p), the order the programs take."""
        cfg = self._config
        S = cfg.max_slots
        tokens = _np.zeros((S, tk), _np.int32)
        positions = _np.zeros((S, tk), _np.int32)
        lengths = _np.zeros(S, _np.int32)
        seeds = _np.zeros(S, _np.uint32)
        counters = _np.zeros(S, _np.uint32)
        temperature = _np.zeros(S, _np.float32)
        top_k = _np.zeros(S, _np.int32)
        top_p = _np.ones(S, _np.float32)
        max_w = 1
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING or r.rid not in rids:
                continue
            fed = [r.seq_tokens[r.ctx_len]] + (drafts or {}).get(r.rid, [])
            tokens[i, :len(fed)] = fed
            positions[i] = r.ctx_len + _np.arange(tk, dtype=_np.int32)
            lengths[i] = len(fed)
            seeds[i] = r.seed
            counters[i] = r.ctx_len + 1  # index of the first token produced
            temperature[i] = r.temperature
            top_k[i] = r.top_k
            top_p[i] = r.top_p
            max_w = max(max_w, blocks_for(r.ctx_len + max(len(fed), span),
                                          cfg.block_size))
        w = bucket_batch(max_w, self._width_buckets)
        tables = _np.zeros((S, w), _np.int32)
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING or r.rid not in rids:
                continue
            n = min(w, len(r.blocks))
            tables[i, :n] = r.blocks[:n]
        if _fault_injector().gen_step_fail(rids):
            raise FaultInjectedError(
                f"injected decode-step failure "
                f"(TPUMX_FAULT_GEN_STEP_FAIL) at iteration "
                f"{self._iteration}, batch rids {sorted(rids)}")
        return (tokens, positions, lengths, tables, seeds, counters,
                temperature, top_k, top_p)

    def _single_step(self, batch: List[_GenRequest]) -> None:
        """The classic one-token decode program (T=1, one sampled token
        per running row)."""
        # copy-on-write append: a slot about to scatter into a shared
        # block (refcount > 1) gets a private copy first — shared prompt
        # history is read-only to every writer (idempotent, so bisection
        # re-entry is safe)
        if self._prefix is not None:
            for r in batch:
                if r.state == _RUNNING:
                    self._cow_for_write(r, r.ctx_len, 1)
        rids = {r.rid for r in batch}
        ops = self._batch_operands(rids)
        w = ops[3].shape[1]
        t_step0 = time.perf_counter()
        with _obs.span("serving.decode", cat="serving",
                       args={"running": len(batch), "width": int(w),
                             "iteration": self._iteration}):
            next_tok, _ = self._programs.run("gen_decode", self._cache,
                                             *ops)
        t_step1 = time.perf_counter()
        traced = _trace.enabled()
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING or r.rid not in rids:
                continue
            # Orca attribution: the ONE shared decode step fans out a
            # child participation span per active request, so each trace
            # still shows every step that advanced it
            r.decode_steps += 1
            if traced and r.trace is not None:
                _trace.record_event(
                    "serving.decode.participate", "serving", t_step0,
                    t_step1, ctx=r.trace,
                    args={"rid": r.rid, "iteration": self._iteration,
                          "running": len(batch),
                          "replica": self._replica_id})
            r.ctx_len += 1
            r.mode_tokens["single"] = r.mode_tokens.get("single", 0) + 1
            self._emit_token(r, int(next_tok[i]))

    def _propose_drafts(self, batch: List[_GenRequest]) -> Dict[int, List[int]]:
        """Draft proposals per request id (possibly empty lists).  Each
        row's proposal count is capped at ``remaining - 1`` so the verify
        emit (``accepted + 1`` tokens) can never overshoot ``max_new`` —
        which also keeps every verify write inside the request's
        worst-case block reservation."""
        cfg = self._config
        out: Dict[int, List[int]] = {}
        rids = {r.rid for r in batch if r.state == _RUNNING}
        if self._draft is not None:
            S = cfg.max_slots
            w = self._draft.window
            window = _np.zeros((S, w), _np.int32)
            positions = _np.zeros((S, w), _np.int32)
            n_valid = _np.zeros(S, _np.int32)
            live = []
            for i, r in enumerate(self._slots):
                if r is None or r.state != _RUNNING or r.rid not in rids:
                    continue
                n = min(r.ctx_len + 1, w)
                window[i, w - n:] = r.seq_tokens[
                    r.ctx_len + 1 - n:r.ctx_len + 1]
                positions[i] = _np.arange(r.ctx_len + 1 - w,
                                          r.ctx_len + 1, dtype=_np.int32)
                n_valid[i] = n
                live.append((i, r))
            if not live:
                return out
            props = self._draft.propose(window, positions, n_valid)
            for i, r in live:
                kmax = min(self._draft.k, r.max_new - r.n_generated - 1)
                out[r.rid] = [int(t) for t in props[i, :max(0, kmax)]]
            return out
        from .speculative import propose_ngram
        for r in batch:
            if r.state != _RUNNING or r.rid not in rids:
                continue
            kmax = min(cfg.draft_k, r.max_new - r.n_generated - 1)
            out[r.rid] = (propose_ngram(
                r.seq_tokens[:r.ctx_len + 1], kmax, cfg.draft_ngram)
                if kmax > 0 else [])
        return out

    def _emit_many(self, r: _GenRequest, toks: List[int]) -> int:
        """Emit consecutive tokens for one request; stops the moment a
        token finishes it (eos / max_new) — surplus verified or scanned
        tokens are simply discarded, exactly as if they were never
        computed.  Returns the number emitted."""
        n = 0
        for t in toks:
            if r.state != _RUNNING or self._killed:
                break
            r.ctx_len += 1
            self._emit_token(r, int(t))
            n += 1
        return n

    def _spec_step(self, batch: List[_GenRequest],
                   drafts: Dict[int, List[int]]) -> None:
        """One speculative iteration: feed ``[pending, d_1..d_s]`` per
        row through a single cache-aware multi-query verify step and emit
        the leading run of target-matching tokens (plus the bonus token).
        Rows with no drafts ride along at chunk length 1 — for them this
        IS the single-token step."""
        cfg = self._config
        rids = {r.rid for r in batch if r.state == _RUNNING}
        smax = max((len(drafts.get(r.rid, ())) for r in batch
                    if r.state == _RUNNING), default=0)
        tk = bucket_batch(smax + 1, self._verify_buckets)
        # copy-on-write over the whole verify span: REJECTED writes land
        # at positions >= ctx_len too, and must never touch a shared
        # block — this is the rollback guarantee (shared prefix blocks
        # are physically unreachable from a speculative scatter)
        if self._prefix is not None:
            for r in batch:
                if r.state == _RUNNING:
                    self._cow_for_write(
                        r, r.ctx_len, len(drafts.get(r.rid, ())) + 1)
        ops = self._batch_operands(rids, tk, drafts)
        lengths, w = ops[2], ops[3].shape[1]
        t_step0 = time.perf_counter()
        with _obs.span("serving.spec_verify", cat="serving",
                       args={"running": len(batch), "width": int(w),
                             "chunk": int(tk),
                             "iteration": self._iteration}):
            target, accepted = self._programs.run_verify(self._cache, *ops)
        t_step1 = time.perf_counter()
        traced = _trace.enabled()
        bs = cfg.block_size
        quantized = self._cache.quantized
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING or r.rid not in rids:
                continue
            s_i = int(lengths[i]) - 1  # drafts fed for this row
            n_emit = int(accepted[i]) + 1
            r.decode_steps += 1
            emitted = self._emit_many(
                r, [int(t) for t in target[i, :n_emit]])
            acc = max(0, emitted - 1)
            r.draft_proposed += s_i
            r.draft_accepted += acc
            r.mode_tokens["spec"] = r.mode_tokens.get("spec", 0) + emitted
            self._counts["draft_proposed"] += s_i
            self._counts["draft_accepted"] += acc
            if s_i:
                self._c_draft_proposed.inc(s_i)
            if acc:
                self._c_draft_accepted.inc(acc)
            # int8 pool + partial rejection: the boundary block now holds
            # accepted entries requantized under a scale that saw the
            # rejected garbage — never index it for sharing (f32 pools
            # need no such cap: every write is position-exact)
            if quantized and s_i > acc and r.ctx_len % bs != 0:
                safe = (r.ctx_len // bs) * bs
                r.index_safe_len = (safe if r.index_safe_len is None
                                    else min(r.index_safe_len, safe))
            if traced and r.trace is not None:
                _trace.record_event(
                    "serving.decode.participate", "serving", t_step0,
                    t_step1, ctx=r.trace,
                    args={"rid": r.rid, "iteration": self._iteration,
                          "running": len(batch), "mode": "spec",
                          "proposed": s_i, "accepted": acc,
                          "replica": self._replica_id})
        self._counts["spec_steps"] += 1

    def _choose_multistep_k(self, batch: List[_GenRequest]) -> int:
        """Adaptive multi-step length: inside an ``engine.bulk`` scope
        ``fusion_hint`` drives k (the caller explicitly asked for
        dispatch amortization); otherwise a non-empty waiting queue
        forces k=1 so admission latency never regresses — a queued
        request joins the batch at the very next token, exactly as
        before.  The result is floored onto the pow2 ladder and bounded
        by every row's remaining budget (a scanned token past max_new
        would be computed only to be discarded)."""
        cfg = self._config
        if cfg.multistep_k < 2 or not self._ms_buckets:
            return 1
        rows = [r for r in batch if r.state == _RUNNING]
        if not rows:
            return 1
        from ...engine import fusion_hint
        hint = fusion_hint()
        if hint > 1:
            want = min(cfg.multistep_k, hint)
        elif len(self._waiting) > 0:
            return 1
        else:
            want = cfg.multistep_k
        want = min(want, min(r.max_new - r.n_generated for r in rows))
        k = 1
        for b in self._ms_buckets:
            if b <= want:
                k = b
        return k

    def _multistep_step(self, batch: List[_GenRequest], k: int) -> None:
        """k decode iterations in one dispatch (one CUDA-graph replay on the
        card) — the same per-iteration math as :meth:`_single_step`
        (tokens and int8 write pattern bit-identical), with k-1
        host↔device round trips amortized away."""
        rids = {r.rid for r in batch if r.state == _RUNNING}
        if self._prefix is not None:
            for r in batch:
                if r.state == _RUNNING:
                    self._cow_for_write(r, r.ctx_len, k)
        tokens, positions, *rest = self._batch_operands(rids, span=k)
        w = rest[1].shape[1]
        t_step0 = time.perf_counter()
        with _obs.span("serving.multistep", cat="serving",
                       args={"running": len(batch), "width": int(w),
                             "k": int(k),
                             "iteration": self._iteration}):
            toks = self._programs.run_multistep(
                k, self._cache, tokens.reshape(-1), positions.reshape(-1),
                *rest)
        t_step1 = time.perf_counter()
        traced = _trace.enabled()
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING or r.rid not in rids:
                continue
            r.decode_steps += 1
            emitted = self._emit_many(r, [int(t) for t in toks[i]])
            r.mode_tokens["multistep"] = \
                r.mode_tokens.get("multistep", 0) + emitted
            if traced and r.trace is not None:
                _trace.record_event(
                    "serving.decode.participate", "serving", t_step0,
                    t_step1, ctx=r.trace,
                    args={"rid": r.rid, "iteration": self._iteration,
                          "running": len(batch), "mode": "multistep",
                          "k": int(k), "replica": self._replica_id})
        self._counts["multistep_steps"] += 1

    # -- failure isolation ------------------------------------------------------
    def _note_step_failure(self, exc: BaseException) -> None:
        self._counts["step_failures"] += 1
        self._consec_step_failures += 1
        self._c_step_fail.inc()

    def _decode_isolated(self, running: List[_GenRequest]) -> None:
        """Decode with bounded blast radius: run the full batch; on
        failure retry once (transient faults recover with zero client
        impact), then bisect so only the poisoned request is quarantined
        while every healthy slot still advances this iteration."""
        for attempt in (0, 1):
            try:
                self._decode_step(running)
                self._consec_step_failures = 0
                return
            except Exception as exc:  # noqa: BLE001 — isolate below
                self._note_step_failure(exc)
                if self._programs.broken is not None:
                    return  # the loop fails every request next
                for r in running:  # attributed per request (wide event)
                    r.n_retries += 1
        self._bisect_decode(running)

    def _bisect_decode(self, group: List[_GenRequest],
                       cause: Optional[BaseException] = None) -> None:
        group = [r for r in group if r.state == _RUNNING]
        if not group or self._programs.broken is not None:
            return
        if len(group) == 1:
            r = group[0]
            quarantined = False
            with self._lock:
                for i, s in enumerate(self._slots):
                    if s is r and r.state == _RUNNING:
                        self._counts["quarantined"] += 1
                        self._c_quarantine.inc()
                        self._release_slot_locked(
                            i, error=GenerationStepError(
                                f"request {r.rid} quarantined: decode step "
                                f"fails whenever it is scheduled "
                                f"(last error: {cause!r})"))
                        quarantined = True
                        break
            if quarantined:
                # postmortems start from data: the black box carries the
                # quarantined request's wide event
                _flight.dump("gen_quarantine", extra={
                    "rid": r.rid, "replica": self._replica_id,
                    "cause": repr(cause), "request": r.wide_event})
            return
        mid = len(group) // 2
        for half in (group[:mid], group[mid:]):
            try:
                self._decode_step(half)
                self._consec_step_failures = 0
            except Exception as exc:  # noqa: BLE001 — keep narrowing
                self._note_step_failure(exc)
                self._bisect_decode(half, exc)

    def _requeue_or_fail(self, r: _GenRequest, exc: BaseException) -> None:
        """Blast-radius containment for one request (prefill error or an
        iteration error that never touched it): requeue it — bounded by
        the error-requeue budget — instead of failing it."""
        err = exc if isinstance(exc, ServingError) else ServingError(
            f"generation step failed: {exc!r}")
        failed = False
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is r:
                    if r.n_requeues < self._max_error_requeues:
                        self._preempt_slot_locked(i, counter="requeued")
                    else:
                        self._release_slot_locked(
                            i, error=GenerationStepError(
                                f"request {r.rid} failed after "
                                f"{r.n_requeues} error requeues: {err}"))
                        failed = True
                    break
        if failed:
            _flight.dump("gen_requeue_budget", extra={
                "rid": r.rid, "replica": self._replica_id,
                "cause": repr(exc), "request": r.wide_event})

    def _absorb_iteration_error(self, exc: BaseException,
                                progress: Dict[int, int]) -> None:
        """An iteration blew up outside the isolated decode path: requests
        the failing iteration advanced keep their slots and keep decoding;
        untouched ones are requeued (bounded), never failed — the step-
        exception blast radius stays at zero healthy casualties."""
        for r in list(self._slots):
            if r is None or r.state != _RUNNING:
                continue
            touched = r.n_generated != progress.get(r.rid, r.n_generated)
            if not touched:
                self._requeue_or_fail(r, exc)

    def _emit_token(self, r: _GenRequest, tok: int) -> None:
        if self._killed:
            return  # a dead replica leaks nothing: the router may already
            #         have resubmitted this request elsewhere
        now = time.perf_counter()
        r.seq_tokens.append(tok)
        r.n_generated += 1
        if len(r.token_log) < 4096:
            r.token_log.append(now)
        if r.t_first is None:
            r.t_first = now
            # snapshot the lifetime partition AT the first token: these
            # components sum exactly to measured TTFT (the wide event's
            # ttft_breakdown_ms)
            r.seg(r.seg_state, now)
            r.breakdown_first = dict(r.breakdown)
            ttft = now - r.t_submit
            self._ttft.append(ttft)
            self._h_ttft.observe(ttft)
        else:
            itl = now - r.t_last
            self._itl.append(itl)
            self._h_itl.observe(itl)
        r.t_last = now
        self._token_times.append(now)
        self._counts["tokens"] += 1
        self._c_tokens.inc()
        r.out_queue.put(("tok", tok))
        if r.on_token is not None:
            try:
                r.on_token(r.rid, tok)
            except Exception:  # callbacks must not kill the engine
                pass
        if r.eos_token is not None and tok == r.eos_token:
            r.state = _FINISHED
            r.finish_reason = "eos"
            self._counts["finished"] += 1
        elif r.n_generated >= r.max_new:
            r.state = _FINISHED
            r.finish_reason = "max_new_tokens"
            self._counts["finished"] += 1

    # -- introspection ------------------------------------------------------------
    def _live_blocks_locked(self) -> int:
        """Blocks holding WRITTEN context across the running slots (owned
        blocks minus reservation/growth headroom)."""
        bs = self._config.block_size
        return sum(blocks_for(r.ctx_len, bs)
                   for r in self._slots
                   if r is not None and r.ctx_len > 0)

    def live_occupancy(self) -> float:
        """Fraction of the allocatable pool holding written KV context —
        unlike ``allocator.occupancy()`` (owned blocks), reservation and
        growth headroom do not count."""
        total = self._config.num_blocks - 1
        with self._lock:
            live = self._live_blocks_locked()
        return live / total if total else 0.0

    def _update_gauges_locked(self) -> None:
        alloc = self._cache.allocator
        total = self._config.num_blocks - 1
        running = sum(1 for r in self._slots if r is not None)
        self._g_running.set(running)
        self._g_waiting.set(len(self._waiting))
        self._g_blocks_used.set(alloc.num_used)
        self._g_blocks_free.set(alloc.num_free)
        self._g_live_occupancy.set(
            self._live_blocks_locked() / total if total else 0.0)
        if self._prefix is not None:
            self._g_blocks_shared.set(alloc.num_shared)
            self._g_pc_blocks.set(self._prefix.num_blocks)
            ev = self._prefix.evictions
            if ev > self._pc_evictions_seen:
                self._c_pc_evict.inc(ev - self._pc_evictions_seen)
                self._pc_evictions_seen = ev
            self._counts["prefix_evictions"] = ev
        occ = alloc.occupancy()
        self._peak_occupancy = max(self._peak_occupancy, occ)
        self._g_occupancy.set(occ)
        if self._iteration % 64 == 0:
            # periodic metric deltas into the flight recorder's note ring:
            # a dead replica's dump shows how its load evolved, not just
            # its final snapshot
            _flight.note("gen_metrics", {
                "replica": self._replica_id, "iteration": self._iteration,
                "running": running, "waiting": len(self._waiting),
                "occupancy": round(occ, 4),
                "tokens": self._counts["tokens"],
                "preempted": self._counts["preempted"],
                "step_failures": self._counts["step_failures"]})
        now = time.perf_counter()
        while self._token_times and \
                now - self._token_times[0] > self._TPS_WINDOW:
            self._token_times.popleft()
        self._g_tps.set(len(self._token_times) / self._TPS_WINDOW)

    def membership_history(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """Per-iteration decode-batch membership ``(iteration, sorted
        request ids)`` — the observable form of iteration-level
        scheduling (tests assert a short request leaves and a queued one
        joins while a long one keeps decoding)."""
        return list(self._membership)

    def compile_stats(self) -> Dict[tuple, Dict[str, int]]:
        """Per-step-signature hit/miss counters (1 miss each after a
        covering :meth:`warmup`)."""
        return self._programs.compile_stats()

    def stats(self) -> dict:
        from .. import metrics as _smetrics

        with self._lock:
            counts = dict(self._counts)
            waiting = len(self._waiting)
            running = sum(1 for r in self._slots if r is not None)
            ttft = list(self._ttft)
            itl = list(self._itl)
        alloc = self._cache.allocator
        pct = _smetrics.percentile
        return {
            "running": running,
            "waiting": waiting,
            "iterations": self._iteration,
            "counts": counts,
            "kv_blocks": {
                "total": self._cache.num_blocks - 1,
                "used": alloc.num_used,
                "free": alloc.num_free,
                "shared": alloc.num_shared,
                "occupancy": round(alloc.occupancy(), 4),
                "live_occupancy": round(self.live_occupancy(), 4),
                "peak_occupancy": round(self._peak_occupancy, 4),
            },
            "prefix_cache": (None if self._prefix is None else {
                "blocks": self._prefix.num_blocks,
                "hits": counts["prefix_hits"],
                "misses": counts["prefix_misses"],
                "cached_tokens": counts["cached_tokens"],
                "prefill_tokens": counts["prefill_tokens"],
                "cow_copies": counts["cow_copies"],
                "evictions": self._prefix.evictions,
            }),
            "ttft_ms": {"p50": _ms(pct(ttft, 50)), "p99": _ms(pct(ttft, 99))},
            "inter_token_ms": {"p50": _ms(pct(itl, 50)),
                               "p99": _ms(pct(itl, 99))},
            "decode_mode": ("spec" if self._config.speculative else
                            "multistep" if self._config.multistep_k >= 2
                            else "single"),
            "speculative": (None if not self._config.speculative else {
                "draft_mode": self._config.draft_mode,
                "draft_k": self._config.draft_k,
                "proposed_tokens": counts["draft_proposed"],
                "accepted_tokens": counts["draft_accepted"],
                "accepted_ratio": (
                    None if counts["draft_proposed"] == 0 else
                    round(counts["draft_accepted"]
                          / counts["draft_proposed"], 4)),
                "mean_accepted_len": (
                    None if counts["spec_steps"] == 0 else
                    round(counts["draft_accepted"]
                          / counts["spec_steps"], 4)),
                "spec_steps": counts["spec_steps"],
            }),
            "multistep": {"k": self._config.multistep_k,
                          "steps": counts["multistep_steps"]},
            "compiled_signatures": self._programs.compiled_signatures(),
            "step_seconds": self._programs.step_seconds(),
            "decode_kernel": self._programs.kernel,
            "kv_dtype": self._config.kv_dtype or str(self._cache.dtype)
            .replace("torch.", ""),
            "device": str(self._device),
            "seq_buckets": list(self._seq_buckets),
            "width_buckets": list(self._width_buckets),
            "closed": self._closed,
            "killed": self._killed,
            "preemption": self._config.preemption,
            "watermarks": {"high": self._config.watermark_high,
                           "low": self._config.watermark_low},
            "consecutive_step_failures": self._consec_step_failures,
        }


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)
