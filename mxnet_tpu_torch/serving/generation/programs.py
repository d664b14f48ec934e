"""The generation engine's model step and block copy.

PyTorch counterpart of ``mxnet_tpu/serving/generation/programs.py`` for
the ``gen_prefill`` / ``gen_decode`` / ``gen_block_copy`` kinds.  ONE step
function serves both phases — prefill (B=1, T=seq bucket) and decode
(B=max_slots, T=1) — built from
:func:`~mxnet_tpu_torch.parallel.transformer.transformer_lm_decode` with
the paged-attention kernel, plus the per-row sampler of
:mod:`mxnet_tpu_torch.ops.sampling`; :func:`_model_step_q` is its int8-pool
variant.  :func:`block_copy_pools` is the copy-on-write primitive of
prefix caching.

The port runs the step eagerly (no jit); the KV pools (and the int8
pool's scales) are written in place.  It keeps the reference's
per-signature bookkeeping — each distinct ``(kind, batch, chunk, table
width)`` is a signature with hit/miss counts, the int8 pool's keys
carrying ``("kv_dtype", "int8")`` — so
:meth:`GenerationPrograms.compile_stats` still counts the finite
step-shape set a warmed service runs (the set a CUDA-graph capture will
key on in a later slice).
"""
from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as _np
import torch

from ...context import resolve_device
from ...ops.sampling import sample_logits
from ...parallel.transformer import transformer_lm_decode

__all__ = ["GenerationPrograms", "block_copy_pools"]

#: the decode-attention implementation every step runs: the CUDA kernel
#: walking the block table (its plain version on CPU tensors)
KERNEL = "paged"


def block_copy_pools(k_pool, v_pool, src: int, dst: int, k_scale=None,
                     v_scale=None) -> None:
    """Copy physical block ``src`` onto ``dst`` across every layer of the
    paged pool, in place — the copy-on-write primitive of prefix caching:
    a writer whose target block is shared gets a private copy before its
    first scatter.  The int8 pool's per-(layer, block, head) scales travel
    with their block (its bits mean nothing without them)."""
    pools = [k_pool, v_pool]
    if k_scale is not None:
        pools += [k_scale, v_scale]
    for t in pools:
        t[:, dst] = t[:, src]


def _last_valid(logits, lengths, T):
    """Logits at the LAST VALID position of each row, which feed the
    sampler (prefill: position len-1 predicts token len; decode: T=1 row
    0)."""
    last_idx = (lengths.long() - 1).clamp(0, T - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device),
                  last_idx]


def _model_step(params, k_pool, v_pool, tokens, positions, lengths,
                block_tables, seeds, counters, temperature, top_k, top_p,
                *, cfg):
    logits, k_pool, v_pool = transformer_lm_decode(
        params, tokens, positions, lengths, k_pool, v_pool, block_tables,
        cfg, attention_kernel=KERNEL)
    last = _last_valid(logits, lengths, tokens.shape[1])
    next_tokens = sample_logits(last, seeds, counters, temperature, top_k,
                                top_p)
    return next_tokens, last


def _model_step_q(params, k_pool, v_pool, k_scale, v_scale, tokens,
                  positions, lengths, block_tables, seeds, counters,
                  temperature, top_k, top_p, *, cfg):
    """The int8-pool variant of :func:`_model_step`: the per-(layer,
    block, head) scales ride as two extra pool operands."""
    logits, *_ = transformer_lm_decode(
        params, tokens, positions, lengths, k_pool, v_pool, block_tables,
        cfg, attention_kernel=KERNEL, k_scale=k_scale, v_scale=v_scale)
    last = _last_valid(logits, lengths, tokens.shape[1])
    next_tokens = sample_logits(last, seeds, counters, temperature, top_k,
                                top_p)
    return next_tokens, last


class GenerationPrograms:
    """Owns the device-resident parameters, the step function and the
    per-signature accounting.  ``kv_dtype="int8"`` runs
    :func:`_model_step_q` against the cache's scales and keys every
    signature with ``("kv_dtype", "int8")``."""

    def __init__(self, params, cfg, compute_dtype=None, device=None,
                 kv_dtype=None):
        self._cfg = cfg
        self._kv_dtype = kv_dtype
        self._device = resolve_device(device)
        self._params = {k: torch.as_tensor(v, dtype=compute_dtype,
                                           device=self._device)
                        for k, v in params.items()}
        self._lock = threading.Lock()
        self._stats: Dict[tuple, Dict[str, int]] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    def _family(self) -> tuple:
        """Key components every signature of this service shares: the
        kernel, and the int8 pool's own program family."""
        fam = (("kernel", KERNEL),)
        if self._kv_dtype == "int8":
            fam += (("kv_dtype", "int8"),)
        return fam

    def _key(self, kind: str, cache, tokens, block_tables) -> tuple:
        sig = (("tokens", tuple(tokens.shape), "int32"),
               ("block_tables", tuple(block_tables.shape), "int32"),
               ("kv_pool", cache.shape, str(cache.k.dtype)))
        return (kind, sig + self._family())

    def _note(self, key: tuple, seconds: float) -> None:
        with self._lock:
            per = self._stats.get(key)
            if per is None:
                self._stats[key] = {"hits": 0, "misses": 1,
                                    "seconds": seconds}
            else:
                per["hits"] += 1
                per["seconds"] += seconds

    def run(self, kind: str, cache, tokens, positions, lengths,
            block_tables, seeds, counters, temperature, top_k, top_p):
        """Execute one step (host numpy inputs); returns ``(next_tokens
        np(B,), last_logits (B, vocab) tensor)``.  ``cache`` is updated in
        place."""
        t0 = time.perf_counter()
        key = self._key(kind, cache, tokens, block_tables)
        dev = self._device

        def put(a, dtype):
            return torch.from_numpy(_np.asarray(a, dtype)).to(dev)

        args = (put(tokens, _np.int64), put(positions, _np.int32),
                put(lengths, _np.int32), put(block_tables, _np.int32),
                _np.asarray(seeds, _np.uint32),
                _np.asarray(counters, _np.uint32),
                put(temperature, _np.float32), put(top_k, _np.int64),
                put(top_p, _np.float32))
        if self._kv_dtype == "int8":
            next_tokens, last = _model_step_q(
                self._params, cache.k, cache.v, cache.k_scale, cache.v_scale,
                *args, cfg=self._cfg)
        else:
            next_tokens, last = _model_step(self._params, cache.k, cache.v,
                                            *args, cfg=self._cfg)
        next_tokens = next_tokens.cpu().numpy()  # waits for the device
        self._note(key, time.perf_counter() - t0)
        return next_tokens, last

    def copy_block(self, cache, src: int, dst: int) -> None:
        """Copy pool block ``src`` onto ``dst`` (scales included for the
        int8 pool) — the copy-on-write append of prefix caching.  One
        signature per pool family (kind ``gen_block_copy``)."""
        t0 = time.perf_counter()
        key = ("gen_block_copy",
               (("kv_pool", cache.shape, str(cache.k.dtype)),)
               + self._family())
        block_copy_pools(cache.k, cache.v, int(src), int(dst),
                         cache.k_scale, cache.v_scale)
        self._note(key, time.perf_counter() - t0)

    def compile_stats(self) -> Dict[tuple, Dict[str, int]]:
        """Per-signature ``{"hits", "misses", "seconds"}``: a signature's
        first run is its one miss; ``seconds`` is the host wall time of
        all its runs, each ending when the sampled tokens reach the
        host."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def step_seconds(self) -> Dict[str, dict]:
        """Steps run and their wall seconds, by kind (prefill / decode)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for (kind, _), per in self._stats.items():
                agg = out.setdefault(kind, {"steps": 0, "seconds": 0.0})
                agg["steps"] += per["hits"] + per["misses"]
                agg["seconds"] += per["seconds"]
        return out

    def compiled_signatures(self) -> int:
        with self._lock:
            return len(self._stats)
