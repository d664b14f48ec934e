"""Decoder-only Transformer LM of the port.

PyTorch counterpart of ``mxnet_tpu/parallel/transformer.py`` for the
serving slice: the config, the initializer, the full-sequence forward
(:func:`transformer_lm_apply`, the generation oracle) and the cache-aware
model step (:func:`transformer_lm_decode`) over a paged KV pool.

Parameters are a flat dict of tensors with the JAX package's keys and
layouts (``x @ W``, ``d_model``-major, tied input/output embeddings), so
:func:`params_from_jax` carries the reference's weights across byte for
byte and both packages compute the same function from the same bytes.

Kernels on this path: every LayerNorm is ``ops.layer_norm.layer_norm_fused``
(2 per block plus the final one) and the paged attention of
:func:`transformer_lm_decode` is ``ops.paged_attention.paged_attention``
(one per block).  On CUDA tensors both launch their hand-written kernels;
on CPU tensors they take their plain versions.

Unlike the functional reference, :func:`transformer_lm_decode` writes the
chunk's K/V into the pools IN PLACE (the reference donates them to get the
same effect) and returns the same pool tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..ops.layer_norm import layer_norm_fused
from ..ops.paged_attention import (attention_scale, paged_attention,
                                   paged_attention_reference)
from .ring_attention import local_attention

__all__ = ["TransformerConfig", "transformer_lm_init", "params_from_jax",
           "transformer_lm_apply", "transformer_lm_decode"]

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_len: int = 512

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def transformer_lm_init(cfg: TransformerConfig, seed: int = 0,
                        device=None) -> Params:
    """Scaled-normal init with the reference's scales (residual-out
    projections down-scaled by 1/sqrt(2*n_layers)), drawn on the CPU from
    a ``torch.Generator`` seeded with ``seed`` and moved to ``device``.
    The values differ from the JAX initializer's; :func:`params_from_jax`
    carries those across."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))

    def normal(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    s = 1.0 / math.sqrt(cfg.d_model)
    res = s / math.sqrt(2.0 * cfg.n_layers)
    d, f = cfg.d_model, cfg.d_ff
    ones = lambda n: torch.ones(n, device=dev)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    p: Params = {
        "tok_emb": normal((cfg.vocab, d), 0.02),
        "pos_emb": normal((cfg.max_len, d), 0.02),
        "lnf_g": ones(d),
        "lnf_b": zeros(d),
    }
    for i in range(cfg.n_layers):
        p[f"l{i}_ln1_g"] = ones(d)
        p[f"l{i}_ln1_b"] = zeros(d)
        p[f"l{i}_wqkv"] = normal((d, 3 * d), s)
        p[f"l{i}_wo"] = normal((d, d), res)
        p[f"l{i}_ln2_g"] = ones(d)
        p[f"l{i}_ln2_b"] = zeros(d)
        p[f"l{i}_w1"] = normal((d, f), s)
        p[f"l{i}_b1"] = zeros(f)
        p[f"l{i}_w2"] = normal((f, d), res)
        p[f"l{i}_b2"] = zeros(d)
    return p


def params_from_jax(params: Dict[str, np.ndarray], device=None,
                    dtype=None) -> Params:
    """The port's parameters from the JAX package's parameter dict (numpy
    arrays, same keys, same layouts — no transposes), on ``device``
    (default ``cuda``), optionally cast to ``dtype``."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v, copy=True)).to(dev)
        out[k] = t if dtype is None else t.to(dtype)
    return out


def _ln(x, g, b, eps=1e-5):
    return layer_norm_fused(x, g, b, eps=eps)


def _mlp(x, params, i):
    h = _ln(x, params[f"l{i}_ln2_g"], params[f"l{i}_ln2_b"])
    a = F.gelu(h @ params[f"l{i}_w1"] + params[f"l{i}_b1"],
               approximate="tanh")
    return x + a @ params[f"l{i}_w2"] + params[f"l{i}_b2"]


def transformer_lm_apply(params: Params, tokens, positions,
                         cfg: TransformerConfig, attention=None):
    """Logits for next-token prediction (the full-sequence oracle).

    tokens: (B, T) integer tensor; positions: (T,) integer tensor of global
    positions; attention: (q, k, v) -> out over (B, T, H, Dh), default
    causal :func:`local_attention`.  Returns (B, T, vocab)."""
    if attention is None:
        attention = functools.partial(local_attention, causal=True)
    tokens = tokens.long()
    B, T = tokens.shape
    x = params["tok_emb"][tokens] + params["pos_emb"][positions.long()][None]
    for i in range(cfg.n_layers):
        h = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
        q, k, v = (h @ params[f"l{i}_wqkv"]).split(cfg.d_model, dim=-1)
        to_heads = lambda t: t.reshape(B, T, cfg.n_heads, cfg.d_head)  # noqa: E731
        o = attention(to_heads(q), to_heads(k), to_heads(v))
        x = x + o.reshape(B, T, cfg.d_model) @ params[f"l{i}_wo"]
        x = _mlp(x, params, i)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T


def transformer_lm_decode(params: Params, tokens, positions, lengths,
                          k_pool, v_pool, block_tables,
                          cfg: TransformerConfig,
                          attention_kernel: Optional[str] = None):
    """Cache-aware forward over a paged per-layer KV cache — the generation
    engine's one model step for both prefill chunks and T=1 decode.

    tokens : (B, T) — the chunk fed this call (right-padded).
    positions : (B, T) — global positions of those tokens.
    lengths : (B,) — valid query count per row; 0 marks an inactive slot
        (its writes go to the reserved null block 0).
    k_pool, v_pool : (n_layers, num_blocks, block_size, n_heads, d_head),
        block 0 the null/scratch block; written IN PLACE.
    block_tables : (B, W) — logical block j of row b lives in physical
        block ``block_tables[b, j]``.
    attention_kernel : ``"paged"`` (default) walks the block table in
        :func:`~mxnet_tpu_torch.ops.paged_attention.paged_attention`;
        ``"gather"`` gathers the context and attends densely.

    Returns ``(logits (B, T, vocab) float32, k_pool, v_pool)``.  A query at
    position p attends to cache entries at positions <= p, including this
    chunk's own, so a prefill followed by T=1 steps reproduces
    :func:`transformer_lm_apply`.  Parameters and pools share one dtype:
    the caller casts once (the service's ``amp_dtype``) where the
    reference takes a per-call ``compute_dtype``."""
    dev = k_pool.device
    as_i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)  # noqa: E731
    tokens = torch.as_tensor(tokens, device=dev).long()
    B, T = tokens.shape
    _, _, block_size, n_heads, d_head = k_pool.shape
    tables = as_i32(block_tables).contiguous()
    W = tables.shape[1]
    positions = as_i32(positions).clamp(0, cfg.max_len - 1).contiguous()
    valid = torch.arange(T, device=dev)[None, :] \
        < as_i32(lengths).long()[:, None]
    # write coordinates, shared by every layer; padded / inactive queries
    # write into the null block 0
    pos64 = positions.long()
    logical = (pos64 // block_size).clamp(0, W - 1)
    phys = torch.where(valid, torch.gather(tables.long(), 1, logical), 0)
    offs = pos64 % block_size
    kernel = attention_kernel or "paged"
    if kernel not in ("paged", "gather"):
        raise ValueError(f"attention_kernel must be 'paged' or 'gather', "
                         f"got {kernel!r}")
    scale = attention_scale(d_head)
    if kernel == "paged":
        # last valid query position per row; -1 skips every block
        max_pos = torch.where(valid, positions, -1).amax(dim=1) \
            .to(torch.int32).contiguous()
    else:
        ctx_pos = torch.arange(W * block_size, device=dev)
        attn_mask = ctx_pos[None, None, :] <= pos64[:, :, None]

    x = params["tok_emb"][tokens] + params["pos_emb"][pos64]
    for i in range(cfg.n_layers):
        h = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
        q, k, v = (h @ params[f"l{i}_wqkv"]).split(cfg.d_model, dim=-1)
        q = q.reshape(B, T, n_heads, d_head).contiguous()
        k_pool[i].index_put_((phys, offs),
                             k.reshape(B, T, n_heads, d_head).to(
                                 k_pool.dtype))
        v_pool[i].index_put_((phys, offs),
                             v.reshape(B, T, n_heads, d_head).to(
                                 v_pool.dtype))
        if kernel == "paged":
            o = paged_attention(q, k_pool[i], v_pool[i], tables, positions,
                                max_pos, scale=scale)
        else:
            k_ctx = k_pool[i][tables.long()].reshape(
                B, W * block_size, n_heads, d_head)
            v_ctx = v_pool[i][tables.long()].reshape(
                B, W * block_size, n_heads, d_head)
            o = paged_attention_reference(q, k_ctx, v_ctx, attn_mask, scale)
        x = x + o.reshape(B, T, cfg.d_model) @ params[f"l{i}_wo"]
        x = _mlp(x, params, i)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = x @ params["tok_emb"].T
    return logits.float(), k_pool, v_pool
