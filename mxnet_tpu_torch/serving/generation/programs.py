"""The generation engine's model step.

PyTorch counterpart of ``mxnet_tpu/serving/generation/programs.py`` for
the ``gen_prefill`` / ``gen_decode`` kinds.  ONE step function serves both
phases — prefill (B=1, T=seq bucket) and decode (B=max_slots, T=1) — built
from :func:`~mxnet_tpu_torch.parallel.transformer.transformer_lm_decode`
with the paged-attention kernel, plus the per-row sampler of
:mod:`mxnet_tpu_torch.ops.sampling`.

The port runs the step eagerly (no jit); the KV pools are written in
place.  It keeps the reference's per-signature bookkeeping — each distinct
``(kind, batch, chunk, table width)`` is a signature with hit/miss counts
— so :meth:`GenerationPrograms.compile_stats` still counts the finite
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

__all__ = ["GenerationPrograms"]

#: the decode-attention implementation every step runs: the CUDA kernel
#: walking the block table (its plain version on CPU tensors)
KERNEL = "paged"


def _model_step(params, k_pool, v_pool, tokens, positions, lengths,
                block_tables, seeds, counters, temperature, top_k, top_p,
                *, cfg):
    logits, k_pool, v_pool = transformer_lm_decode(
        params, tokens, positions, lengths, k_pool, v_pool, block_tables,
        cfg, attention_kernel=KERNEL)
    # logits at the LAST VALID position of each row feed the sampler
    # (prefill: position len-1 predicts token len; decode: T=1 row 0)
    last_idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
    last = logits[torch.arange(tokens.shape[0], device=logits.device),
                  last_idx]
    next_tokens = sample_logits(last, seeds, counters, temperature, top_k,
                                top_p)
    return next_tokens, last


class GenerationPrograms:
    """Owns the device-resident parameters, the step function and the
    per-signature accounting."""

    def __init__(self, params, cfg, compute_dtype=None, device=None):
        self._cfg = cfg
        self._device = resolve_device(device)
        self._params = {k: torch.as_tensor(v, dtype=compute_dtype,
                                           device=self._device)
                        for k, v in params.items()}
        self._lock = threading.Lock()
        self._stats: Dict[tuple, Dict[str, int]] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    def _key(self, kind: str, cache, tokens, block_tables) -> tuple:
        sig = (("tokens", tuple(tokens.shape), "int32"),
               ("block_tables", tuple(block_tables.shape), "int32"),
               ("kv_pool", cache.shape, str(cache.k.dtype)),
               ("kernel", KERNEL))
        return (kind, sig)

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

        next_tokens, last = _model_step(
            self._params, cache.k, cache.v, put(tokens, _np.int64),
            put(positions, _np.int32), put(lengths, _np.int32),
            put(block_tables, _np.int32), _np.asarray(seeds, _np.uint32),
            _np.asarray(counters, _np.uint32),
            put(temperature, _np.float32), put(top_k, _np.int64),
            put(top_p, _np.float32), cfg=self._cfg)
        next_tokens = next_tokens.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        with self._lock:
            per = self._stats.get(key)
            if per is None:
                self._stats[key] = {"hits": 0, "misses": 1, "seconds": dt}
            else:
                per["hits"] += 1
                per["seconds"] += dt
        return next_tokens, last

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
