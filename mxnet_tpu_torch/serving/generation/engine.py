"""GenerationService — continuous-batching autoregressive decoding.

PyTorch counterpart of ``mxnet_tpu/serving/generation/engine.py``.  The
scheduling model is the reference's (Orca's iteration-level scheduling
over vLLM's paged KV cache): the engine owns ``max_slots`` decode slots;
every loop iteration it (1) evicts finished/cancelled/expired requests and
frees their cache blocks, (2) under incremental allocation (the default,
``preemption=True``) preempts victims when the pool crosses its high
watermark and grows every running request's block table, oldest admitted
first, (3) admits waiting requests into free slots — priority classes
first, FIFO within a class — taking the blocks their context needs (the
worst case under ``preemption=False``), reusing cached prompt blocks when
the prefix cache (default on) holds them, and prefills their uncached
context through the bucketed (past the smallest rung, chunked) prefill,
then (4) runs ONE decode step over all occupied slots, advancing every
running request by one token.  A preempted request goes back to the queue
with its context and re-prefills it on re-admission.  Shared prefix
blocks are read-only: a writer copies a shared block before scattering
into it (copy-on-write).  Tokens stream back per request through
:class:`GenerationStream`, with the queue bound, backpressure policies and
deadlines of the reference.

The model step runs on the service's device (default ``cuda``) through the
port's CUDA kernels: fused LayerNorm and paged attention, whose int8-pool
variant serves ``kv_dtype="int8"`` (``mxnet_tpu_torch.ops``).  Greedy and
sampled tokens match the JAX package's for the same parameters: sampling
is keyed on (request seed, position) with the reference's threefry bits.

Speculative and multi-step decoding, model parallelism, retry/bisection
quarantine of failing steps, fault injection, request tracing, the flight
recorder and the metrics registry come with later slices;
:class:`GenerationConfig` raises ``NotImplementedError`` naming any of the
first three when asked for it.  A failing step fails the requests it ran
(no requeue or bisection yet).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as _np
import torch

from ...base import getenv
from ..batcher import (BACKPRESSURE_POLICIES, DeadlineExceededError,
                       QueueFullError, RequestShedError, ServingClosedError,
                       ServingError)
from ..bucketing import (batch_buckets, bucket_batch, bucket_seq_len,
                         pad_tokens_right, seq_buckets)
from .kv_cache import PagedKVCache, blocks_for
from .prefix_cache import PrefixCacheIndex
from .programs import KERNEL, GenerationPrograms

__all__ = ["GenerationConfig", "GenerationService", "GenerationStream",
           "GenerationStepError"]


class GenerationStepError(ServingError):
    """A model step failed while this request was part of it."""


_WAITING, _RUNNING, _FINISHED, _CANCELLED, _FAILED = (
    "waiting", "running", "finished", "cancelled", "failed")

_AMP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GenerationConfig:
    """Knobs for :class:`GenerationService`, with the reference's names,
    defaults, ``TPUMX_GEN_*`` environment variables and validation.

    Served: reserve-ahead or incremental allocation with preemption
    (``preemption``, the watermarks), the prefix cache
    (``prefix_cache``, ``prefix_cache_blocks``), the int8 KV pool
    (``kv_dtype="int8"``) and float32/bfloat16 ``amp_dtype``.  Not ported
    yet, refused with ``NotImplementedError``: ``speculative=True``,
    ``multistep_k > 1``, ``mp_devices > 1`` and any other ``amp_dtype``
    (their companion knobs, the draft settings and ``shard_rules``, come
    with them)."""

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
                 preemption: Optional[bool] = None,
                 watermark_high: Optional[float] = None,
                 watermark_low: Optional[float] = None,
                 admission_budget: Optional[float] = None,
                 kv_dtype: Optional[str] = "__env__",
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_blocks: Optional[int] = None,
                 speculative: Optional[bool] = None,
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
            self.default_deadline_ms: Optional[float] = \
                float(default_deadline_ms)
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
        self.mp_devices = int(mp_devices if mp_devices is not None
                              else getenv("TPUMX_GEN_MP_DEVICES", 1))
        if self.mp_devices < 1:
            raise ValueError("mp_devices must be >= 1")
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
        self.speculative = bool(
            speculative if speculative is not None
            else getenv("TPUMX_GEN_SPECULATIVE", 0))
        self.multistep_k = int(multistep_k if multistep_k is not None
                               else getenv("TPUMX_GEN_MULTISTEP_K", 1))
        if self.multistep_k < 1:
            raise ValueError("multistep_k must be >= 1")
        later = [("speculative", False, "speculative decoding"),
                 ("multistep_k", 1, "multi-step decoding"),
                 ("mp_devices", 1, "model-parallel serving")]
        for name, served, feature in later:
            if getattr(self, name) != served:
                raise NotImplementedError(
                    f"GenerationConfig {name}={getattr(self, name)!r}: "
                    f"{feature} is not ported yet; pass {name}={served!r}")

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
                f"prefix_cache={self.prefix_cache})")


class _GenRequest:
    """Engine-internal per-request state."""

    __slots__ = ("rid", "prompt_len", "seq_tokens", "max_new",
                 "temperature", "top_k", "top_p", "seed", "eos_token",
                 "deadline", "on_token", "state", "blocks", "ctx_len",
                 "n_generated", "out_queue", "done_event", "error",
                 "finish_reason", "t_submit", "t_first", "t_last",
                 "cancel_requested", "priority", "admit_seq",
                 "n_preempted", "cached_len", "cached_total",
                 "cow_copies", "charged_blocks", "index_safe_len")

    def __init__(self, rid, prompt, max_new, temperature, top_k,
                 top_p, seed, eos_token, deadline, on_token, priority=0):
        self.rid = rid
        self.prompt_len = len(prompt)
        self.seq_tokens: List[int] = [int(t) for t in prompt]
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
        self.n_preempted = 0       # preemptions survived
        # prefix caching: tokens served from shared blocks at the last
        # admission / over the request's lifetime, copy-on-write copies
        # taken, and the overload estimator's submit-time charge
        self.cached_len = 0
        self.cached_total = 0
        self.cow_copies = 0
        self.charged_blocks = 0
        # the longest context prefix whose int8 bits are safe to index
        # (None = all of it); only speculative decoding, not ported yet,
        # ever caps it
        self.index_safe_len: Optional[int] = None

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

    def __init__(self, req: _GenRequest):
        self._req = req

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
        """Whether the engine has emitted at least one token."""
        return self._req.t_first is not None


def _percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) over a non-empty list."""
    if not samples:
        return None
    xs = sorted(samples)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


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
        When False the engine loop is not launched until :meth:`start`.
    device : the device the model and KV pool live on (default ``cuda``;
        pass ``"cpu"`` to run the plain versions on the CPU).
    """

    def __init__(self, params, model_cfg, config: Optional[GenerationConfig]
                 = None, start: bool = True, device=None):
        self._model_cfg = model_cfg
        self._config = config or GenerationConfig()
        cfg = self._config
        compute_dtype = _AMP_DTYPES[cfg.amp_dtype] if cfg.amp_dtype else None
        self._programs = GenerationPrograms(params, model_cfg,
                                            compute_dtype=compute_dtype,
                                            device=device,
                                            kv_dtype=cfg.kv_dtype)
        self._device = self._programs.device
        self._cache = PagedKVCache(
            model_cfg.n_layers, model_cfg.n_heads, model_cfg.d_head,
            cfg.num_blocks, cfg.block_size,
            dtype=compute_dtype or torch.float32, device=self._device,
            kv_dtype=cfg.kv_dtype)
        self._cache.allocator.set_watermarks(cfg.watermark_high,
                                             cfg.watermark_low)
        # the chain-hash index over resident full blocks; None with the
        # prefix cache off
        self._prefix = (PrefixCacheIndex(
            self._cache.allocator, cfg.block_size,
            capacity_blocks=cfg.prefix_cache_blocks)
            if cfg.prefix_cache else None)
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

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._waiting: "deque[_GenRequest]" = deque()
        self._slots: List[Optional[_GenRequest]] = [None] * cfg.max_slots
        self._closed = False
        self._drain = True
        self._next_rid = 0
        self._admit_seq = 0           # admission recency for victim order
        self._iteration = 0
        self._membership: "deque" = deque(maxlen=4096)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._autostart = bool(start)
        self._counts = {"submitted": 0, "finished": 0, "cancelled": 0,
                        "failed": 0, "rejected": 0, "expired": 0,
                        "shed": 0, "tokens": 0, "preempted": 0,
                        "step_failures": 0, "prefix_hits": 0,
                        "prefix_misses": 0, "prefix_evictions": 0,
                        "cached_tokens": 0, "prefill_tokens": 0,
                        "cow_copies": 0}
        self._peak_occupancy = 0.0
        self._ttft: "deque[float]" = deque(maxlen=4096)
        self._itl: "deque[float]" = deque(maxlen=4096)

    # -- submission ---------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_token: Optional[int] = "__config__",
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               timeout: Optional[float] = None,
               priority: int = 0) -> GenerationStream:
        """Enqueue one generation request; returns a stream handle.

        ``prompt``: 1-D int token ids, at most the largest seq bucket long.
        ``temperature <= 0`` is greedy; ``top_k``/``top_p`` follow
        :mod:`mxnet_tpu_torch.ops.sampling`.  ``seed`` keys the request's
        private sampling randomness.  ``deadline_ms`` bounds total
        queue+generate time.  ``on_token(rid, token)`` is called from the
        engine thread per token.  ``timeout`` bounds a blocking submit
        under the ``block`` policy.  Higher ``priority`` classes are
        admitted first and preempted last (ties FIFO / newest admitted
        first)."""
        cfg = self._config
        if self._closed:
            raise ServingClosedError("generation service is shut down")
        prompt = _np.asarray(prompt, dtype=_np.int64).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if _np.any(prompt < 0) or _np.any(prompt >= self._model_cfg.vocab):
            raise ValueError(
                f"prompt token ids must be in [0, {self._model_cfg.vocab})")
        # over-long prompts are rejected here (bucket_seq_len raises)
        bucket_seq_len(prompt.size, self._seq_buckets)
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
        # with the prefix cache on, blocks the index would serve are not
        # new demand: charge the projected uncached suffix plus one block
        # of copy-on-write slack
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
                # projected blocks of everything queued+running, plus this
                # request: the policy fires before the pool thrashes, not
                # when the queue fills
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
                              max_new, temperature, top_k, top_p,
                              seed, eos, deadline, on_token,
                              priority=priority)
            req.charged_blocks = charge
            self._next_rid += 1
            self._waiting.append(req)
            self._counts["submitted"] += 1
            self._not_empty.notify_all()
        if self._autostart:
            self._ensure_worker()
        return GenerationStream(req)

    def generate(self, prompt, **kwargs) -> List[int]:
        """Blocking convenience wrapper: ``submit(...).result()``."""
        timeout = kwargs.pop("timeout", None)
        return self.submit(prompt, **kwargs).result(timeout)

    # -- lifecycle ----------------------------------------------------------------
    def start(self) -> None:
        """Launch the engine loop (idempotent)."""
        self._autostart = True
        self._ensure_worker()

    def _ensure_worker(self) -> None:
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
        """Run the entire steady-state step-shape set once — one prefill
        per (T, W) signature the chunk planner can emit (re-prefills and
        prefix-cache suffixes included), one decode per block-table-width
        bucket, and the copy-on-write block copy when the prefix cache is
        on — so first requests pay no one-time library set-up.  All rows
        are inactive (length 0): the steps write only the null block.
        Returns the number of new signatures."""
        cfg = self._config
        before = self._programs.compiled_signatures()
        S = cfg.max_slots
        zeros_s = _np.zeros(S, _np.int32)
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
        if self._prefix is not None:
            # copying the reserved null block onto itself warms the copy
            # without touching real cache state
            self._programs.copy_block(self._cache, 0, 0)
        return self._programs.compiled_signatures() - before

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Shut down.  ``drain=True`` finishes running AND queued requests
        first; ``drain=False`` fails them with ServingClosedError."""
        started = self._worker is not None and self._worker.is_alive()
        with self._lock:
            self._closed = True
            self._drain = drain
            if not started:
                # no loop to hand them to
                while self._waiting:
                    self._finish_locked(self._waiting.popleft(),
                                        error=ServingClosedError(
                                            "generation service shutting "
                                            "down; queued request rejected"))
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if started:
            self._worker.join(timeout)
        if self._prefix is not None:
            # release the cache's own block references (blocks still held
            # by live requests merely lose their shared status)
            self._prefix.drop_all()

    # -- the engine loop ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
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
                    return
                if self._config.preemption:
                    self._watermark_preempt_locked()
                    self._grow_blocks_locked()
                admitted = self._admit_locked()
                active = [r for r in self._slots if r is not None]
                if not active and not admitted:
                    if self._closed and not self._waiting:
                        return
                    self._not_empty.wait(0.05)
                    continue
            for req in admitted:
                try:
                    self._prefill(req)
                except Exception as exc:  # noqa: BLE001 — fail only this one
                    self._fail_requests([req], exc)
            running = [r for r in self._slots
                       if r is not None and r.state == _RUNNING]
            self._membership.append(
                (self._iteration, tuple(sorted(r.rid for r in running))))
            if running:
                try:
                    self._single_step(running)
                except Exception as exc:  # noqa: BLE001 — the loop survives
                    self._fail_requests(running, exc)
            self._iteration += 1
            with self._lock:
                self._peak_occupancy = max(
                    self._peak_occupancy,
                    self._cache.allocator.occupancy())

    def _fail_requests(self, reqs: List[_GenRequest],
                       exc: BaseException) -> None:
        """A step raised: fail the requests it ran, keep the engine up."""
        with self._lock:
            self._counts["step_failures"] += 1
            for r in reqs:
                for i, s in enumerate(self._slots):
                    if s is r and r.state == _RUNNING:
                        self._release_slot_locked(i, error=GenerationStepError(
                            f"request {r.rid}: generation step failed: "
                            f"{exc!r}"))

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
        allocation the current context plus the next written position;
        under reserve-ahead the full worst case."""
        cfg = self._config
        if cfg.preemption:
            ctx = r.ctx_len if r.ctx_len > 0 else r.prompt_len
            return blocks_for(ctx + 1, cfg.block_size)
        return blocks_for(r.prompt_len + r.max_new, cfg.block_size)

    def _admit_locked(self) -> List[_GenRequest]:
        """Priority-class-then-FIFO admission: fill free slots while the
        best waiting request's block need fits (head-of-line blocking
        within the chosen class is the deliberate fairness policy).  The
        longest cached prefix of its context is shared, not allocated.
        Under incremental allocation, admission also leaves the
        high-watermark headroom intact unless nothing is running."""
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
                else:
                    self._counts["prefix_misses"] += 1
            head.state = _RUNNING
            head.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._slots[free.pop(0)] = head
            admitted.append(head)
            self._not_full.notify_all()
        return admitted

    def _alloc_reclaiming(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting cache-only prefix blocks (LRU)
        when the free list alone cannot cover it — the cache yields to
        live demand before any running request is preempted.  Safe with
        or without the service lock: allocator and index lock themselves."""
        alloc = self._cache.allocator
        got = alloc.allocate(n)
        if got is None and self._prefix is not None:
            self._prefix.evict_blocks(int(n) - alloc.num_free)
            got = alloc.allocate(n)
        return got

    def _cow_for_write(self, r: _GenRequest, off: int, take: int) -> None:
        """Copy-on-write: before a scatter into positions ``[off, off +
        take)``, every target block with ``refcount > 1`` (shared prompt
        history) is replaced by a private copy, so writers never touch
        shared blocks.  Runs on the engine thread with no service lock."""
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
            self._programs.copy_block(self._cache, b, fresh[0])
            r.blocks[li] = fresh[0]
            alloc.decref([b])
            r.cow_copies += 1
            self._counts["cow_copies"] += 1

    def _index_safe_ctx(self, r: _GenRequest) -> int:
        """Longest context prefix whose cache bits are safe to share via
        the prefix index: the whole context unless ``index_safe_len``
        caps it."""
        if r.index_safe_len is None:
            return r.ctx_len
        return min(r.ctx_len, r.index_safe_len)

    def _pick_victim_locked(self) -> Optional[int]:
        """Victim slot for preemption: lowest priority class first, then
        newest admitted (the oldest request keeps progressing, which
        guarantees liveness)."""
        best_i = None
        best_key = None
        for i, r in enumerate(self._slots):
            if r is None or r.state != _RUNNING:
                continue
            key = (r.priority, -r.admit_seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def _preempt_slot_locked(self, i: int) -> None:
        """Move a running request back to the front of the waiting queue:
        its blocks go back to the pool, its context stays — re-admission
        re-prefills it (tokens stay identical: sampling is keyed on
        (seed, position) only).  Its written full blocks are indexed first,
        so with the prefix cache on they stay resident and the re-prefill
        re-hits them."""
        r = self._slots[i]
        self._slots[i] = None
        if r.blocks:
            if self._prefix is not None and self._index_safe_ctx(r) > 0:
                self._prefix.insert(
                    r.seq_tokens[:self._index_safe_ctx(r)], r.blocks)
            self._cache.allocator.free(r.blocks)
            r.blocks = None
        r.state = _WAITING
        self._waiting.appendleft(r)
        r.n_preempted += 1
        self._counts["preempted"] += 1

    def _watermark_preempt_locked(self) -> None:
        """Crossing the high watermark preempts victims down to the low
        watermark, so near-term growth never hits a hard exhaust mid-step.
        Cache-only blocks are evicted first; the last running request is
        never preempted (its worst case was validated at submit)."""
        alloc = self._cache.allocator
        if not alloc.above_high():
            return
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
        one more block, oldest admitted first.  Exhaustion preempts the
        victim policy's pick; a grower that IS the pick preempts itself."""
        cfg = self._config
        order = sorted(
            (i for i, r in enumerate(self._slots)
             if r is not None and r.state == _RUNNING),
            key=lambda i: self._slots[i].admit_seq)
        for i in order:
            r = self._slots[i]
            if r is None or r.state != _RUNNING:
                continue  # preempted by an earlier grower this pass
            need = blocks_for(min(r.ctx_len + 1, r.prompt_len + r.max_new),
                              cfg.block_size)
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
        """KV demand of everything queued + running, the overload
        estimator's input: each request's submit-time charge (its worst
        case, less what the prefix index projected to serve)."""
        bs = self._config.block_size
        reqs = list(self._waiting) + [r for r in self._slots if r is not None]
        return sum(r.charged_blocks or blocks_for(r.prompt_len + r.max_new,
                                                  bs)
                   for r in reqs)

    def _release_slot_locked(self, i: int, reason: str = _FINISHED,
                             error: Optional[BaseException] = None) -> None:
        r = self._slots[i]
        self._slots[i] = None
        if r.blocks:
            # keep a cleanly finished request's full blocks resident for
            # the next shared-prompt arrival (an errored request's cache
            # state is suspect)
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
        r.done_event.set()

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
        # re-admission after preemption: replay the whole context (prompt
        # + generated tokens) through the chunked-prefill rungs and emit
        # nothing — the pending token at index ctx_len is already in
        # seq_tokens and the next decode feeds it
        resumed = r.ctx_len > 0
        ctx = r.ctx_len if resumed else r.prompt_len
        cached = min(r.cached_len, ctx)
        if cached >= ctx and resumed:
            plan = []  # the whole written context is resident: nothing to do
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
            plan = self._chunk_plan(ctx, start=cached)
        else:
            plan = self._chunk_plan(ctx, force_chunked=resumed)
        for (off, take, tb, wp) in plan:
            self._cow_for_write(r, off, take)
            table = _np.zeros((1, wp), _np.int32)
            n = min(wp, len(r.blocks))
            table[0, :n] = r.blocks[:n]
            tokens = pad_tokens_right(
                _np.asarray(r.seq_tokens[off:off + take], _np.int32),
                tb)[None, :]
            positions = _np.arange(off, off + tb, dtype=_np.int32)[None, :]
            # only the final chunk's sample (global position ctx-1) is
            # emitted; earlier chunks exist to fill the cache
            next_tok, _ = self._programs.run(
                "gen_prefill", self._cache, tokens, positions,
                _np.asarray([take], _np.int32), table,
                _np.asarray([r.seed], _np.uint32),
                _np.asarray([ctx], _np.uint32),
                _np.asarray([r.temperature], _np.float32),
                _np.asarray([r.top_k], _np.int32),
                _np.asarray([r.top_p], _np.float32))
        self._counts["prefill_tokens"] += sum(p[1] for p in plan)
        # make this context's full blocks available to the next shared-
        # prompt arrival now, not only at finish
        if self._prefix is not None and not resumed:
            self._prefix.insert(r.seq_tokens[:ctx], r.blocks)
        if resumed:
            return
        r.ctx_len = r.prompt_len
        self._emit_token(r, int(next_tok[0]))

    def _single_step(self, batch: List[_GenRequest]) -> None:
        """One decode step (T=1, one sampled token per running row) over
        the requests in ``batch``; other slots stay inactive (length 0,
        null-block table)."""
        cfg = self._config
        S = cfg.max_slots
        # copy-on-write append: a slot about to scatter into a shared block
        # gets a private copy first
        for r in batch:
            if r.state == _RUNNING:
                self._cow_for_write(r, r.ctx_len, 1)
        rids = {r.rid for r in batch}
        tokens = _np.zeros((S, 1), _np.int32)
        positions = _np.zeros((S, 1), _np.int32)
        lengths = _np.zeros(S, _np.int32)
        seeds = _np.zeros(S, _np.uint32)
        counters = _np.zeros(S, _np.uint32)
        temperature = _np.zeros(S, _np.float32)
        top_k = _np.zeros(S, _np.int32)
        top_p = _np.ones(S, _np.float32)
        live = [(i, r) for i, r in enumerate(self._slots)
                if r is not None and r.state == _RUNNING and r.rid in rids]
        max_w = 1
        for i, r in live:
            tokens[i, 0] = r.seq_tokens[r.ctx_len]
            positions[i, 0] = r.ctx_len
            lengths[i] = 1
            seeds[i] = r.seed
            counters[i] = r.ctx_len + 1  # index of the token being produced
            temperature[i] = r.temperature
            top_k[i] = r.top_k
            top_p[i] = r.top_p
            max_w = max(max_w, blocks_for(r.ctx_len + 1, cfg.block_size))
        w = bucket_batch(max_w, self._width_buckets)
        tables = _np.zeros((S, w), _np.int32)
        for i, r in live:
            n = min(w, len(r.blocks))
            tables[i, :n] = r.blocks[:n]
        next_tok, _ = self._programs.run(
            "gen_decode", self._cache, tokens, positions, lengths, tables,
            seeds, counters, temperature, top_k, top_p)
        for i, r in live:
            r.ctx_len += 1
            self._emit_token(r, int(next_tok[i]))

    def _emit_token(self, r: _GenRequest, tok: int) -> None:
        now = time.perf_counter()
        r.seq_tokens.append(tok)
        r.n_generated += 1
        if r.t_first is None:
            r.t_first = now
            self._ttft.append(now - r.t_submit)
        else:
            self._itl.append(now - r.t_last)
        r.t_last = now
        self._counts["tokens"] += 1
        r.out_queue.put(("tok", tok))
        if r.on_token is not None:
            try:
                r.on_token(r.rid, tok)
            except Exception:  # noqa: BLE001 — callbacks must not kill it
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
    def membership_history(self):
        """Per-iteration decode-batch membership ``(iteration, sorted
        request ids)`` — the observable form of iteration-level
        scheduling."""
        return list(self._membership)

    def compile_stats(self):
        """Per-step-signature hit/miss counters (1 miss each after a
        covering :meth:`warmup`)."""
        return self._programs.compile_stats()

    def stats(self) -> dict:
        with self._lock:
            if self._prefix is not None:
                self._counts["prefix_evictions"] = self._prefix.evictions
            counts = dict(self._counts)
            waiting = len(self._waiting)
            running = sum(1 for r in self._slots if r is not None)
            ttft = list(self._ttft)
            itl = list(self._itl)
        alloc = self._cache.allocator
        cfg = self._config
        ms = lambda s: None if s is None else round(s * 1e3, 3)  # noqa: E731
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
                "peak_occupancy": round(self._peak_occupancy, 4),
            },
            "prefix_cache": (None if self._prefix is None else {
                "blocks": self._prefix.num_blocks,
                "hits": counts["prefix_hits"],
                "misses": counts["prefix_misses"],
                "cached_tokens": counts["cached_tokens"],
                "prefill_tokens": counts["prefill_tokens"],
                "cow_copies": counts["cow_copies"],
                "evictions": counts["prefix_evictions"],
            }),
            "ttft_ms": {"p50": ms(_percentile(ttft, 50)),
                        "p99": ms(_percentile(ttft, 99))},
            "inter_token_ms": {"p50": ms(_percentile(itl, 50)),
                               "p99": ms(_percentile(itl, 99))},
            "compiled_signatures": self._programs.compiled_signatures(),
            "step_seconds": self._programs.step_seconds(),
            "decode_kernel": KERNEL,
            "kv_dtype": cfg.kv_dtype or str(self._cache.dtype).replace(
                "torch.", ""),
            "device": str(self._device),
            "seq_buckets": list(self._seq_buckets),
            "width_buckets": list(self._width_buckets),
            "closed": self._closed,
            "preemption": cfg.preemption,
            "watermarks": {"high": cfg.watermark_high,
                           "low": cfg.watermark_low},
        }
