"""GenerationService — continuous-batching autoregressive decoding.

PyTorch counterpart of ``mxnet_tpu/serving/generation/engine.py``.  The
scheduling model is the reference's (Orca's iteration-level scheduling
over vLLM's paged KV cache): the engine owns ``max_slots`` decode slots;
every loop iteration it (1) evicts finished/cancelled/expired requests and
frees their cache blocks, (2) admits waiting requests into free slots —
priority classes first, FIFO within a class — reserving each one's
worst-case blocks, running its prompt through the bucketed (and, past the
smallest rung, chunked) prefill, then (3) runs ONE decode step over all
occupied slots, advancing every running request by one token.  Tokens
stream back per request through :class:`GenerationStream`, with the queue
bound, backpressure policies and deadlines of the reference.

The model step runs on the service's device (default ``cuda``) through the
port's CUDA kernels: fused LayerNorm and paged attention
(``mxnet_tpu_torch.ops``).  Greedy and sampled tokens match the JAX
package's for the same parameters: sampling is keyed on (request seed,
position) with the reference's threefry bits.

This slice serves the reference's ``preemption=False`` /
``prefix_cache=False`` / single-token path.  Incremental allocation with
victim preemption, prefix caching with copy-on-write, speculative and
multi-step decoding, the int8 KV pool, model parallelism, retry/bisection
quarantine of failing steps, fault injection, request tracing, the flight
recorder and the metrics registry come with later slices;
:class:`GenerationConfig` raises ``NotImplementedError`` naming any of the
first six when asked for it.  A failing step fails the requests it ran
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
    defaults and ``TPUMX_GEN_*`` environment variables.

    The defaults are the reference's, so ``preemption`` and
    ``prefix_cache`` default to True — which this slice does not serve:
    pass ``preemption=False, prefix_cache=False``.  Any value of
    ``preemption``, ``prefix_cache``, ``speculative``, ``multistep_k``,
    ``kv_dtype`` or ``mp_devices`` other than the single-token,
    reserve-ahead, float-pool, one-device setting raises
    ``NotImplementedError``."""

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
                 admission_budget: Optional[float] = None,
                 kv_dtype: Optional[str] = "__env__",
                 prefix_cache: Optional[bool] = None,
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
        # low-precision decode: params and the KV pool in this dtype
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
        # submissions whose projected worst-case blocks (queued + running)
        # would exceed this multiple of the pool hit the backpressure policy
        self.admission_budget = float(
            admission_budget if admission_budget is not None
            else getenv("TPUMX_GEN_ADMISSION_BUDGET", 4.0))
        if self.admission_budget <= 0:
            raise ValueError("admission_budget must be > 0")
        # the reference's features this slice does not serve yet, read
        # with the reference's defaults so nothing changes silently
        self.mp_devices = int(mp_devices if mp_devices is not None
                              else getenv("TPUMX_GEN_MP_DEVICES", 1))
        self.preemption = bool(preemption if preemption is not None
                               else getenv("TPUMX_GEN_PREEMPTION", True))
        if kv_dtype == "__env__":
            raw = os.environ.get("TPUMX_GEN_KV_DTYPE", "").strip().lower()
            kv_dtype = None if raw in ("", "0", "none", "off") else raw
        self.kv_dtype = kv_dtype
        self.prefix_cache = bool(
            prefix_cache if prefix_cache is not None
            else getenv("TPUMX_GEN_PREFIX_CACHE", True))
        self.speculative = bool(
            speculative if speculative is not None
            else getenv("TPUMX_GEN_SPECULATIVE", 0))
        self.multistep_k = int(multistep_k if multistep_k is not None
                               else getenv("TPUMX_GEN_MULTISTEP_K", 1))
        later = [("preemption", False,
                  "incremental KV allocation with victim preemption"),
                 ("prefix_cache", False,
                  "prefix caching with copy-on-write blocks"),
                 ("speculative", False, "speculative decoding"),
                 ("multistep_k", 1, "multi-step decoding"),
                 ("kv_dtype", None, "the int8 KV pool"),
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
                f"amp_dtype={self.amp_dtype!r})")


class _GenRequest:
    """Engine-internal per-request state."""

    __slots__ = ("rid", "prompt_len", "seq_tokens", "max_new",
                 "temperature", "top_k", "top_p", "seed", "eos_token",
                 "deadline", "on_token", "state", "blocks", "ctx_len",
                 "n_generated", "out_queue", "done_event", "error",
                 "finish_reason", "t_submit", "t_first", "t_last",
                 "cancel_requested", "priority")

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
                                            device=device)
        self._device = self._programs.device
        self._cache = PagedKVCache(
            model_cfg.n_layers, model_cfg.n_heads, model_cfg.d_head,
            cfg.num_blocks, cfg.block_size,
            dtype=compute_dtype or torch.float32, device=self._device)
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
        self._iteration = 0
        self._membership: "deque" = deque(maxlen=4096)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._autostart = bool(start)
        self._counts = {"submitted": 0, "finished": 0, "cancelled": 0,
                        "failed": 0, "rejected": 0, "expired": 0,
                        "shed": 0, "tokens": 0, "prefill_tokens": 0,
                        "step_failures": 0}
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
        admitted first (ties FIFO)."""
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
                # worst-case projected blocks of everything queued+running,
                # plus this request: the policy fires before the pool
                # thrashes, not when the queue fills
                if len(self._waiting) >= cfg.queue_bound:
                    return f"generation queue bound {cfg.queue_bound} reached"
                projected = self._projected_blocks_locked() + need
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
        per (T, W) signature the chunk planner can emit, one decode per
        block-table-width bucket — so first requests pay no one-time
        library set-up.  All rows are inactive (length 0): the steps write
        only the null block.  Returns the number of new signatures."""
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

    def _admit_locked(self) -> List[_GenRequest]:
        """Priority-class-then-FIFO admission: fill free slots while the
        best waiting request's worst-case block need fits (head-of-line
        blocking within the chosen class is the deliberate fairness
        policy)."""
        bs = self._config.block_size
        admitted = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._waiting:
            best_i, head = 0, self._waiting[0]
            for j, r in enumerate(self._waiting):
                if r.priority > head.priority:
                    best_i, head = j, r
            blocks = self._cache.allocator.allocate(
                blocks_for(head.prompt_len + head.max_new, bs))
            if blocks is None:
                break
            del self._waiting[best_i]
            head.blocks = blocks
            head.state = _RUNNING
            self._slots[free.pop(0)] = head
            admitted.append(head)
            self._not_full.notify_all()
        return admitted

    def _projected_blocks_locked(self) -> int:
        """Worst-case KV demand of everything queued + running."""
        bs = self._config.block_size
        reqs = list(self._waiting) + [r for r in self._slots if r is not None]
        return sum(blocks_for(r.prompt_len + r.max_new, bs) for r in reqs)

    def _release_slot_locked(self, i: int, reason: str = _FINISHED,
                             error: Optional[BaseException] = None) -> None:
        r = self._slots[i]
        self._slots[i] = None
        if r.blocks:
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
    def _chunk_plan(self, prompt_len: int):
        """Prefill chunking: ``[(off, take, T, W)]``.

        A single entry is the whole prompt padded to its ladder rung, table
        width ``blocks_for(rung)``.  With chunked prefill on and a prompt
        past the smallest rung, the prompt is split greedily into
        rung-sized chunks fed through the same cache-aware prefill step
        (each chunk writes its positions and attends to everything already
        cached); chunk table widths are pow2-bucketed on the decode width
        ladder, keeping the (T, W) signature set finite."""
        cfg = self._config
        rungs = self._seq_buckets
        if not cfg.chunked_prefill or prompt_len <= rungs[0]:
            tb = bucket_seq_len(prompt_len, rungs)
            return [(0, prompt_len, tb, blocks_for(tb, cfg.block_size))]
        chunks = []
        off = 0
        while off < prompt_len:
            rem = prompt_len - off
            fitting = [b for b in rungs if b <= rem]
            tb = fitting[-1] if fitting else rungs[0]
            take = min(rem, tb)
            w = bucket_batch(blocks_for(off + tb, cfg.block_size),
                             self._width_buckets)
            chunks.append((off, take, tb, w))
            off += take
        if len(chunks) == 1:  # exactly one rung: the unchunked plan
            tb = bucket_seq_len(prompt_len, rungs)
            return [(0, prompt_len, tb, blocks_for(tb, cfg.block_size))]
        return chunks

    def _prefill_signatures(self):
        """Every (T, W) prefill signature the chunk planner can emit — the
        warmup set (one pass over the possible prompt lengths)."""
        cfg = self._config
        out = {(tb, blocks_for(tb, cfg.block_size))
               for tb in self._seq_buckets}
        if cfg.chunked_prefill:
            for L in range(1, self._seq_buckets[-1] + 1):
                for (_, _, tb, w) in self._chunk_plan(L):
                    out.add((tb, w))
        return sorted(out)

    def _prefill(self, r: _GenRequest) -> None:
        next_tok = None
        plan = self._chunk_plan(r.prompt_len)
        for (off, take, tb, wp) in plan:
            table = _np.zeros((1, wp), _np.int32)
            n = min(wp, len(r.blocks))
            table[0, :n] = r.blocks[:n]
            tokens = pad_tokens_right(
                _np.asarray(r.seq_tokens[off:off + take], _np.int32),
                tb)[None, :]
            positions = _np.arange(off, off + tb, dtype=_np.int32)[None, :]
            # only the final chunk's sample (global position prompt_len-1)
            # is emitted; earlier chunks exist to fill the cache
            next_tok, _ = self._programs.run(
                "gen_prefill", self._cache, tokens, positions,
                _np.asarray([take], _np.int32), table,
                _np.asarray([r.seed], _np.uint32),
                _np.asarray([r.prompt_len], _np.uint32),
                _np.asarray([r.temperature], _np.float32),
                _np.asarray([r.top_k], _np.int32),
                _np.asarray([r.top_p], _np.float32))
        self._counts["prefill_tokens"] += sum(p[1] for p in plan)
        r.ctx_len = r.prompt_len
        self._emit_token(r, int(next_tok[0]))

    def _single_step(self, batch: List[_GenRequest]) -> None:
        """One decode step (T=1, one sampled token per running row) over
        the requests in ``batch``; other slots stay inactive (length 0,
        null-block table)."""
        cfg = self._config
        S = cfg.max_slots
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
            counts = dict(self._counts)
            waiting = len(self._waiting)
            running = sum(1 for r in self._slots if r is not None)
            ttft = list(self._ttft)
            itl = list(self._itl)
        alloc = self._cache.allocator
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
                "occupancy": round(alloc.occupancy(), 4),
                "peak_occupancy": round(self._peak_occupancy, 4),
            },
            "ttft_ms": {"p50": ms(_percentile(ttft, 50)),
                        "p99": ms(_percentile(ttft, 99))},
            "inter_token_ms": {"p50": ms(_percentile(itl, 50)),
                               "p99": ms(_percentile(itl, 99))},
            "compiled_signatures": self._programs.compiled_signatures(),
            "step_seconds": self._programs.step_seconds(),
            "decode_kernel": KERNEL,
            "kv_dtype": str(self._cache.dtype).replace("torch.", ""),
            "device": str(self._device),
            "seq_buckets": list(self._seq_buckets),
            "width_buckets": list(self._width_buckets),
            "closed": self._closed,
        }
