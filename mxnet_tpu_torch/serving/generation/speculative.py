"""Draft-token proposers for speculative decoding.

PyTorch counterpart of ``mxnet_tpu/serving/generation/speculative.py``.
Two proposal sources feed the engine's multi-query verify step
(``GenerationPrograms.run_verify``):

- :func:`propose_ngram` — self-speculative prompt-lookup drafting: match
  the tail of the request's own token history (prompt + generated)
  against an earlier occurrence and propose the tokens that followed it.
  Host numpy, no second model, no device work;
- :class:`DraftModel` — a small draft transformer (``transformer_lm_init``
  layout) proposing ``k`` greedy continuations per slot in one
  ``(max_slots, window, k)`` call: the k draft steps run over a fixed
  right-aligned context window that is shifted on the device, with one
  host copy of the proposals at the end.  Its LayerNorms are the port's
  ``_ln`` (the LayerNorm kernel on the card); its windowed attention is
  plain torch, as the reference's is an XLA einsum.

Draft proposals never affect output correctness, only the acceptance
rate: verification (:func:`mxnet_tpu_torch.ops.sampling.speculative_verify`)
emits exactly the target model's own ``(seed, position)``-keyed tokens, so
drafts are proposed greedily here, even for sampled requests.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as _np
import torch
import torch.nn.functional as F

from ...observability import recompile as _recompile
from ...ops.paged_attention import attention_scale
from ...ops.sampling import NEG_INF
from ...parallel.transformer import _ln

__all__ = ["propose_ngram", "DraftModel"]


def propose_ngram(tokens, k: int, ngram_max: int,
                  ngram_min: int = 1) -> List[int]:
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the history's trailing n-gram (longest ``n`` first, ``ngram_max`` down
    to ``ngram_min``) and propose up to ``k`` tokens that followed it.

    ``tokens`` is the request's full known history (prompt + generated,
    including the pending token).  Returns ``[]`` when no n-gram repeats;
    the engine then decodes that slot one token at a time."""
    toks = _np.asarray(tokens, dtype=_np.int32)
    L = int(toks.size)
    if k <= 0 or L < ngram_min + 1:
        return []
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        tail = toks[L - n:]
        if L - n - 1 <= 0:
            continue
        windows = _np.lib.stride_tricks.sliding_window_view(
            toks[:L - 1], n)
        hits = _np.flatnonzero((windows == tail).all(axis=1))
        if hits.size == 0:
            continue
        i = int(hits[-1])  # most recent prior occurrence
        cont = toks[i + n:i + n + k]
        if cont.size:
            return [int(t) for t in cont]
    return []


def _draft_logits(params, window, positions, n_valid, cfg):
    """The draft transformer over a right-aligned window: causal within
    the window, padding columns masked.  Returns (S, vocab) f32 logits at
    the window's last column."""
    S, w = window.shape
    dev = window.device
    col = torch.arange(w, device=dev)
    causal = col[None, :, None] >= col[None, None, :]        # (1, q, kc)
    key_ok = col[None, :] >= (w - n_valid)[:, None]           # (S, kc)
    bias = torch.where(causal & key_ok[:, None, :], 0.0, NEG_INF)
    scale = attention_scale(cfg.d_head)
    pos = positions.clamp(0, cfg.max_len - 1)
    x = params["tok_emb"][window] + params["pos_emb"][pos]
    for i in range(cfg.n_layers):
        g = lambda n: params[f"l{i}_{n}"]  # noqa: E731,B023 — read now
        h = _ln(x, g("ln1_g"), g("ln1_b"))
        q, kk, v = (h @ g("wqkv")).split(cfg.d_model, dim=-1)
        to_heads = lambda t: t.reshape(S, w, cfg.n_heads, cfg.d_head)  # noqa: E731
        q, kk, v = to_heads(q), to_heads(kk), to_heads(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
        p = torch.softmax(s + bias[:, None], dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        x = x + o.to(x.dtype).reshape(S, w, cfg.d_model) @ g("wo")
        h = _ln(x, g("ln2_g"), g("ln2_b"))
        x = x + F.gelu(h @ g("w1") + g("b1"), approximate="tanh") \
            @ g("w2") + g("b2")
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return (x[:, -1, :] @ params["tok_emb"].T).float()


def _draft_propose(params, window, positions, n_valid, *, k, cfg):
    """k greedy draft tokens per row from a fixed right-aligned window.

    window : (S, w) int64 — the last ``min(ctx+1, w)`` known tokens of
        each slot, right-aligned (left entries are padding).
    positions : (S, w) int64 — global positions of those columns (padding
        columns may be negative; they are clipped and masked).
    n_valid : (S,) int64 — real tokens per row (0 = inactive slot).

    Returns (S, k) int64 proposals; the window, its positions and its
    valid count advance on the device between the k steps."""
    w = window.shape[1]
    out = []
    for _ in range(k):
        nxt = torch.argmax(_draft_logits(params, window, positions,
                                         n_valid, cfg), dim=-1)
        out.append(nxt)
        window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
        positions = torch.cat([positions[:, 1:], positions[:, -1:] + 1],
                              dim=1)
        n_valid = torch.clamp(n_valid + 1, max=w)
    return torch.stack(out, dim=1)


class DraftModel:
    """The draft proposer: one ``(S, window, k)`` signature, accounted at
    site ``gen_draft`` with the same freeze discipline as the engine's
    model steps."""

    def __init__(self, params, cfg, k: int, window: int,
                 compute_dtype=None, device=None):
        self.cfg = cfg
        self.k = int(k)
        self.window = int(window)
        if self.window < 1:
            raise ValueError("draft_window must be >= 1")
        if self.window > cfg.max_len:
            raise ValueError(
                f"draft_window {self.window} exceeds the draft model's "
                f"max_len {cfg.max_len}")
        from ...context import resolve_device

        self._device = resolve_device(device)
        self._params = {n: torch.as_tensor(v, dtype=compute_dtype,
                                           device=self._device)
                        for n, v in params.items()}
        self._lock = threading.Lock()
        self._stats: Dict[tuple, Dict[str, int]] = {}

    def propose(self, window, positions, n_valid) -> _np.ndarray:
        """(S, k) greedy draft proposals; inactive rows (n_valid 0)
        return garbage the engine ignores."""
        window = _np.asarray(window, _np.int64)
        key = ("gen_draft",
               (("window", tuple(window.shape), "int32"), ("k", self.k)))
        with self._lock:
            per = self._stats.get(key)
            hit = per is not None
            if per is None:
                per = self._stats[key] = {"hits": 0, "misses": 0}
        _recompile.note_cache(hit, ("gen_draft", ("lm",)), key)
        with self._lock:
            per["hits" if hit else "misses"] += 1
        dev = self._device

        def put(a):
            return torch.from_numpy(_np.asarray(a, _np.int64)).to(dev)

        with torch.no_grad():
            out = _draft_propose(self._params, put(window), put(positions),
                                 put(n_valid), k=self.k, cfg=self.cfg)
        return out.cpu().numpy()

    def compile_stats(self) -> Dict[tuple, Dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}
