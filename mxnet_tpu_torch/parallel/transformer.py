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
(one per block; its int8-pool variant when the pool is quantized).  On
CUDA tensors both launch their hand-written kernels; on CPU tensors they
take their plain versions.  The int8 pool's quantizing scatter
(:func:`_scatter_kv_quantized`) is plain torch ops, as it is plain jnp in
the reference.

Unlike the functional reference, :func:`transformer_lm_decode` writes the
chunk's K/V (and the int8 pool's scales) IN PLACE (the reference donates
them to get the same effect) and returns the same tensors.
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


def _scatter_kv_quantized(pool, scale, vals, tables, positions, valid,
                          max_pos, nt: int):
    """Quantizing scatter into ONE layer's int8 paged pool, in place.

    Only the ``nt`` logical blocks this chunk's contiguous positions can
    touch are gathered (decode: one block per row), dequantized with their
    current per-(block, head) scales, updated with the chunk's float K/V,
    re-scaled from the absmax over the WRITTEN prefix, requantized and
    scattered back — bit for bit the reference's arithmetic (round half to
    even, division by the new scale).  A touched block whose scale is
    unchanged requantizes to identical int8 (its absmax entry stores as
    exactly +-127), so a row's bits depend only on its own write history.

    pool: (num_blocks, bs, H, D) int8; scale: (num_blocks, H) f32;
    vals: (B, T, H, D) float; tables: (B, W) int; positions/valid:
    (B, T); max_pos: (B,) last valid position after this write (-1 for
    inactive rows).  Rows with no valid query target block 0, where
    duplicate targets land (the only block written twice).  Returns
    ``(pool, scale)``."""
    B, T, H, D = vals.shape
    bs = pool.shape[1]
    W = tables.shape[1]
    dev = pool.device
    pos = positions.long()
    # positions are contiguous per row, so the row's first entry names the
    # first touched logical block
    l0 = pos[:, 0] // bs                                          # (B,)
    tl = l0[:, None] + torch.arange(nt, device=dev)[None, :]     # (B, nt)
    row_live = valid.any(dim=1)
    j_ok = (tl < W) & row_live[:, None]
    tphys = torch.where(
        j_ok, torch.gather(tables.long(), 1, tl.clamp(max=W - 1)), 0)
    blk = pool[tphys].float() \
        * scale[tphys][:, :, None, :, None]           # (B, nt, bs, H, D)
    bidx = torch.arange(B, device=dev)[:, None]
    j = (pos // bs - l0[:, None]).clamp(0, nt - 1)
    o = pos % bs
    cur = blk[bidx, j, o]
    blk[bidx, j, o] = torch.where(valid[..., None, None], vals.float(), cur)
    # per-(block, head) scale from the absmax over the written prefix only:
    # unwritten tail bits (and stale bits of a reused block) never count
    pos_of = tl[:, :, None] * bs \
        + torch.arange(bs, device=dev)[None, None, :]      # (B, nt, bs)
    live = (pos_of <= max_pos.long()[:, None, None]) & j_ok[:, :, None]
    amax = (blk.abs() * live[..., None, None].float()).amax(dim=(2, 4))
    new_s = torch.clamp_min(amax, 1e-8) / 127.0              # (B, nt, H)
    q = torch.round(blk / new_s[:, :, None, :, None]).clamp(-127, 127)
    pool[tphys] = q.to(torch.int8)
    scale[tphys] = new_s
    return pool, scale


def _touched_blocks(T: int, block_size: int) -> int:
    """Count of logical blocks ``T`` contiguous positions can span at any
    alignment (decode T=1 -> 1)."""
    return (T + block_size - 2) // block_size + 1


def transformer_lm_decode(params: Params, tokens, positions, lengths,
                          k_pool, v_pool, block_tables,
                          cfg: TransformerConfig,
                          attention_kernel: Optional[str] = None,
                          k_scale=None, v_scale=None):
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
    k_scale, v_scale : (n_layers, num_blocks, n_heads) float32, optional —
        given, the pools are int8: the scatter quantizes per (layer, block,
        head) (:func:`_scatter_kv_quantized`, scales updated IN PLACE) and
        both attention paths dequantize at read.

    Returns ``(logits (B, T, vocab) float32, k_pool, v_pool)``, plus
    ``k_scale, v_scale`` for the int8 pool.  A query at position p attends
    to cache entries at positions <= p, including this chunk's own, so a
    prefill followed by T=1 steps reproduces :func:`transformer_lm_apply`.
    Parameters and float pools share one dtype: the caller casts once (the
    service's ``amp_dtype``) where the reference takes a per-call
    ``compute_dtype``."""
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
    quantized = k_scale is not None
    scale = attention_scale(d_head)
    if kernel == "paged" or quantized:
        # last valid query position per row; -1 skips every block
        max_pos = torch.where(valid, positions, -1).amax(dim=1) \
            .to(torch.int32).contiguous()
    if kernel == "gather":
        ctx_pos = torch.arange(W * block_size, device=dev)
        attn_mask = ctx_pos[None, None, :] <= pos64[:, :, None]
    if quantized:
        nt = _touched_blocks(T, block_size)

    def gather_ctx(pool, pool_scale):
        ctx = pool[tables.long()]
        if pool_scale is not None:
            # dequantize at read: per-(block, head) scales broadcast over
            # the gathered context
            ctx = ctx.float() \
                * pool_scale[tables.long()][:, :, None, :, None]
        return ctx.reshape(B, W * block_size, n_heads, d_head)

    x = params["tok_emb"][tokens] + params["pos_emb"][pos64]
    for i in range(cfg.n_layers):
        h = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
        q, k, v = (h @ params[f"l{i}_wqkv"]).split(cfg.d_model, dim=-1)
        q = q.reshape(B, T, n_heads, d_head).contiguous()
        k = k.reshape(B, T, n_heads, d_head)
        v = v.reshape(B, T, n_heads, d_head)
        ks = k_scale[i] if quantized else None
        vs = v_scale[i] if quantized else None
        if quantized:
            _scatter_kv_quantized(k_pool[i], ks, k, tables, positions, valid,
                                  max_pos, nt)
            _scatter_kv_quantized(v_pool[i], vs, v, tables, positions, valid,
                                  max_pos, nt)
        else:
            k_pool[i].index_put_((phys, offs), k.to(k_pool.dtype))
            v_pool[i].index_put_((phys, offs), v.to(v_pool.dtype))
        if kernel == "paged":
            o = paged_attention(q, k_pool[i], v_pool[i], tables, positions,
                                max_pos, scale=scale, k_scale=ks, v_scale=vs)
        else:
            o = paged_attention_reference(q, gather_ctx(k_pool[i], ks),
                                          gather_ctx(v_pool[i], vs),
                                          attn_mask, scale)
        x = x + o.reshape(B, T, cfg.d_model) @ params[f"l{i}_wo"]
        x = _mlp(x, params, i)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = x @ params["tok_emb"].T
    if quantized:
        return logits.float(), k_pool, v_pool, k_scale, v_scale
    return logits.float(), k_pool, v_pool
