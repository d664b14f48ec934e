"""Decoder-only Transformer LM of the port.

PyTorch counterpart of ``mxnet_tpu/parallel/transformer.py``: the
config, the initializer, the full-sequence forward
(:func:`transformer_lm_apply`, the generation oracle), the cache-aware
model step (:func:`transformer_lm_decode`) over a paged KV pool, the
training loss and SGD-momentum step (:func:`lm_loss`, :func:`train_step`),
and the dp x sp step over a mesh (:func:`make_sharded_train_step`, each
rank on its blocks of the batch as :func:`shard_batch` cuts them, ring
or Ulysses attention over ``sp``).  The model-parallel step
(``make_partitioned_train_step``, the partition rules) is not ported.

Parameters are a flat dict of tensors with the JAX package's keys and
layouts (``x @ W``, ``d_model``-major, tied input/output embeddings), so
:func:`params_from_jax` carries the reference's weights across byte for
byte and both packages compute the same function from the same bytes.

Kernels on this path: every LayerNorm is ``ops.layer_norm.layer_norm_fused``
(2 per block plus the final one) and the paged attention of
:func:`transformer_lm_decode` is ``ops.paged_attention.paged_attention``
(one per block; its int8-pool variant when the pool is quantized).
Training with ``attention=ops.flash_attention.flash_attention`` (causal)
runs the flash forward kernel once per block and its dQ and dK/dV kernels
once per block in the backward; LayerNorm's backward is autograd through
its plain version, as in the reference.  On CUDA tensors the wrappers
launch their hand-written kernels; on CPU tensors they take their plain
versions.  The int8 pool's quantizing scatter
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
from .collectives import psum_flat, spmd
from .mesh import NamedSharding, PartitionSpec as P, shard
from .ring_attention import local_attention, ring_attention

__all__ = ["TransformerConfig", "transformer_lm_init", "params_from_jax",
           "transformer_lm_apply", "transformer_lm_decode", "lm_loss",
           "train_step", "make_sharded_train_step", "shard_batch",
           "transformer_partition_rules", "param_shapes", "tp_params",
           "transformer_lm_apply_tp", "transformer_lm_decode_tp",
           "make_partitioned_train_step"]

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


def _identity(x):
    return x


def _block(x, params, i, d_head, attend, enter=_identity, reduce=_identity):
    """Decoder block ``i``: pre-LN attention, then the GELU MLP, each with
    its residual add.  ``attend(i, q, k, v)`` maps (B, T, h, d_head) heads
    to the attention output.  ``enter``/``reduce`` are the tensor-parallel
    collectives (identity on one device): ``enter`` takes the replicated
    normed input into the column-parallel matmuls (QKV, MLP-in), whose
    input cotangents are partial; ``reduce`` sums the row-parallel ones'
    partial outputs (attention-out, MLP-out).  Under tensor parallelism
    ``params`` holds this rank's compute blocks (:func:`tp_params`), QKV
    as head-aligned columns, so the same code computes this rank's
    heads."""
    B, T, _ = x.shape
    h = _ln(x, params[f"l{i}_ln1_g"], params[f"l{i}_ln1_b"])
    q, k, v = (enter(h) @ params[f"l{i}_wqkv"]).chunk(3, dim=-1)
    heads = lambda t: t.reshape(B, T, -1, d_head)  # noqa: E731
    o = attend(i, heads(q), heads(k), heads(v))
    x = x + reduce(o.reshape(B, T, -1) @ params[f"l{i}_wo"])
    h = _ln(x, params[f"l{i}_ln2_g"], params[f"l{i}_ln2_b"])
    a = F.gelu(enter(h) @ params[f"l{i}_w1"] + params[f"l{i}_b1"],
               approximate="tanh")
    return x + reduce(a @ params[f"l{i}_w2"]) + params[f"l{i}_b2"]


def transformer_lm_apply(params: Params, tokens, positions,
                         cfg: TransformerConfig, attention=None):
    """Logits for next-token prediction (the full-sequence oracle).

    tokens: (B, T) integer tensor; positions: (T,) integer tensor of global
    positions; attention: (q, k, v) -> out over (B, T, H, Dh), default
    causal :func:`local_attention`.  Returns (B, T, vocab)."""
    if attention is None:
        attention = functools.partial(local_attention, causal=True)
    x = params["tok_emb"][tokens.long()] \
        + params["pos_emb"][positions.long()][None]
    for i in range(cfg.n_layers):
        x = _block(x, params, i, cfg.d_head,
                   lambda i, q, k, v: attention(q, k, v))
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
    attend, tokens, pos64 = _decode_setup(
        tokens, positions, lengths, k_pool, v_pool, block_tables, cfg,
        attention_kernel, k_scale, v_scale)
    x = params["tok_emb"][tokens] + params["pos_emb"][pos64]
    for i in range(cfg.n_layers):
        x = _block(x, params, i, cfg.d_head, attend)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = x @ params["tok_emb"].T
    if k_scale is not None:
        return logits.float(), k_pool, v_pool, k_scale, v_scale
    return logits.float(), k_pool, v_pool


def _decode_setup(tokens, positions, lengths, k_pool, v_pool, block_tables,
                  cfg, attention_kernel=None, k_scale=None, v_scale=None):
    """The cache side of :func:`transformer_lm_decode`: the write
    coordinates every layer shares, and ``attend(i, q, k, v)``, which
    scatters the chunk's K/V into layer ``i``'s pool (quantizing for the
    int8 pool) and attends over it.  The heads are the pool's: under
    tensor parallelism each rank's pool holds its own head slice.
    Returns ``(attend, tokens (B, T) int64, positions (B, T) int64)``."""
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

    def attend(i, q, k, v):
        q = q.contiguous()
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
            return paged_attention(q, k_pool[i], v_pool[i], tables,
                                   positions, max_pos, scale=scale,
                                   k_scale=ks, v_scale=vs)
        return paged_attention_reference(q, gather_ctx(k_pool[i], ks),
                                         gather_ctx(v_pool[i], vs),
                                         attn_mask, scale)

    return attend, tokens, pos64


def lm_loss(params: Params, tokens, labels, positions,
            cfg: TransformerConfig, attention=None, mask=None,
            compute_dtype=None):
    """Mean next-token cross-entropy; ``mask`` (B, T) optionally excludes
    positions (e.g. padding) from the mean.  ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts every parameter for the forward; the f32
    master weights stay outside and receive the gradient through the cast.
    Log-softmax is taken in f32."""
    dev = params["tok_emb"].device
    if compute_dtype is not None:
        params = {k: v.to(compute_dtype) for k, v in params.items()}
    logits = transformer_lm_apply(params, torch.as_tensor(tokens, device=dev),
                                  torch.as_tensor(positions, device=dev),
                                  cfg, attention)
    return _nll_mean(logits, labels, mask)


def _nll_mean(logits, labels, mask=None):
    """Mean next-token cross-entropy of (B, T, V) logits, log-softmax in
    f32; ``mask`` (B, T) excludes positions from the mean."""
    dev = logits.device
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, device=dev).long()
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=dev).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def train_step(params: Params, momenta: Params, tokens, labels, positions,
               cfg: TransformerConfig, lr=0.1, momentum=0.9, attention=None,
               compute_dtype=None):
    """Single-device SGD-momentum step: ``m = momentum * m + g``, ``p = p -
    lr * m`` for every parameter, with ``g`` the gradient of
    :func:`lm_loss`.  Returns ``(loss, params, momenta)``: a detached f32
    scalar and NEW dicts; the inputs are left as they were."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = lm_loss(leaves, tokens, labels, positions, cfg,
                   attention=attention, compute_dtype=compute_dtype)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new_m = {k: momentum * momenta[k] + g
                 for k, g in zip(leaves, grads)}
        new_p = {k: params[k] - lr * new_m[k] for k in leaves}
    return loss.detach(), new_p, new_m


def make_sharded_train_step(mesh, cfg: TransformerConfig, lr=0.1,
                            momentum=0.9, sp_impl: str = "ring",
                            compute_dtype=None):
    """The dp x sp training step (reference: ``make_sharded_train_step``).

    Each rank calls ``step(params, momenta, tokens, labels, positions)``
    with the replicated params and momenta and its own blocks of the
    batch, as :func:`shard_batch` cuts them: tokens and labels by
    ``P("dp", "sp")``, positions by ``P("sp")``.  Attention over ``sp`` is
    the causal ring (``sp_impl="ring"``) or Ulysses (``"ulysses"``: dense,
    ``"ulysses_flash"``: the flash kernels between the two all-to-alls;
    both need ``n_heads % sp == 0``).  The local mean loss is divided by
    the number of shards and its gradient summed explicitly over
    (``dp``, ``sp``), as the reference does under ``check=False``: the
    attention collectives' backwards carry the cotangents across ranks and
    sum nothing.  Returns ``(loss, params, momenta)``, replicated: the
    global mean loss (f32, detached) and new dicts, the inputs untouched.
    """
    axes = ("dp", "sp")
    if sp_impl in ("ulysses", "ulysses_flash"):
        from .sequence_parallel import ulysses_attention

        if cfg.n_heads % mesh.shape["sp"]:
            raise ValueError(
                f"ulysses needs n_heads ({cfg.n_heads}) divisible by "
                f"sp ({mesh.shape['sp']})")
        attn_fn = functools.partial(
            ulysses_attention,
            impl="flash" if sp_impl == "ulysses_flash" else "dense")
    elif sp_impl == "ring":
        attn_fn = ring_attention
    else:
        raise ValueError(f"unknown sp_impl {sp_impl!r}")
    attention = functools.partial(attn_fn, axis_name="sp", causal=True)
    n_shards = mesh.shape["dp"] * mesh.shape["sp"]

    def step(params, momenta, tokens, labels, positions):
        with spmd(mesh):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = lm_loss(leaves, tokens, labels, positions, cfg,
                           attention=attention,
                           compute_dtype=compute_dtype) / n_shards
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                *grads, loss = psum_flat([*grads, loss.detach()], axes)
                new_m = {k: momentum * momenta[k] + g
                         for k, g in zip(leaves, grads)}
                new_p = {k: params[k] - lr * new_m[k] for k in leaves}
        return loss, new_p, new_m

    return step


def shard_batch(mesh, tokens, labels, positions):
    """This rank's blocks of the host arrays, with the layout
    :func:`make_sharded_train_step` expects, on the mesh's device."""
    data = NamedSharding(mesh, P("dp", "sp"))
    pos = NamedSharding(mesh, P("sp"))
    return shard(tokens, data), shard(labels, data), shard(positions, pos)


# -- tensor parallelism and the partition rules -------------------------------------
def transformer_partition_rules(mp_axis: str = "mp"):
    """The transformer LM's Megatron-style placement over the model axis
    as a rule set (``partition_rules``): the QKV and MLP-in projections
    shard their OUTPUT features (column-parallel), attention-out and
    MLP-out their INPUT features (row-parallel), the embeddings their
    feature dim; LayerNorm gains/biases and the MLP biases replicate."""
    return (
        (r"wqkv$|w1$", (None, mp_axis)),     # column-parallel (out features)
        (r"wo$|w2$", (mp_axis, None)),       # row-parallel (in features)
        (r"tok_emb$|pos_emb$", (None, mp_axis)),
        (r"ln\w*_[gb]$|_b1$|_b2$", ()),      # norms + biases replicate
    )


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Name -> shape of :func:`transformer_lm_init`'s parameters."""
    d, f = cfg.d_model, cfg.d_ff
    out = {"tok_emb": (cfg.vocab, d), "pos_emb": (cfg.max_len, d),
           "lnf_g": (d,), "lnf_b": (d,)}
    for i in range(cfg.n_layers):
        out.update({f"l{i}_ln1_g": (d,), f"l{i}_ln1_b": (d,),
                    f"l{i}_wqkv": (d, 3 * d), f"l{i}_wo": (d, d),
                    f"l{i}_ln2_g": (d,), f"l{i}_ln2_b": (d,),
                    f"l{i}_w1": (d, f), f"l{i}_b1": (f,),
                    f"l{i}_w2": (f, d), f"l{i}_b2": (d,)})
    return out


def _tp_layout(name: str, shape, cfg: TransformerConfig, r: int, n: int,
               embed_full: bool):
    """How tensor-parallel compute reads parameter ``name`` on rank ``r``
    of ``n``: ``None`` (the whole array) or ``(dim, index, block)`` — the
    indices this rank takes along ``dim``, ``block`` True when they are
    the plain r-th contiguous block.  QKV takes each of q, k and v's
    r-th column block (its heads), which a contiguous column split of
    the (D, 3D) weight does not give."""
    if n == 1:
        return None

    def blk(dim):
        b = shape[dim] // n
        return dim, torch.arange(r * b, (r + 1) * b), True

    if name.endswith("_wqkv"):
        d = cfg.d_model // n
        cols = torch.cat([torch.arange(j * cfg.d_model + r * d,
                                       j * cfg.d_model + (r + 1) * d)
                          for j in range(3)])
        return 1, cols, False
    if name.endswith(("_wo", "_w2")):
        return blk(0)
    if name.endswith("_w1"):
        return blk(1)
    if name.endswith("_b1"):
        return blk(0)
    if name in ("tok_emb", "pos_emb") and not embed_full:
        return blk(1)
    return None


def _tp_check(cfg: TransformerConfig, n: int, what: str) -> None:
    from ..base import MXNetError

    if cfg.n_heads % n or cfg.d_ff % n:
        raise MXNetError(
            f"{what}: tensor parallelism over mp={n} needs n_heads "
            f"({cfg.n_heads}) and d_ff ({cfg.d_ff}) divisible by {n}")


def _mp_coords(mesh, axis: str):
    if mesh is None or axis not in mesh.shape:
        return 0, 1
    return mesh.axis_index(axis), mesh.shape[axis]


def _live_spec(spec, mesh) -> tuple:
    """``spec`` without the axes of size 1 (a dim split once is whole)."""
    out = []
    for e in spec or ():
        axes = [a for a in (e if isinstance(e, tuple) else (e,))
                if a is not None and mesh.shape.get(a, 1) > 1]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _same_block(spec, layout, axis: str) -> bool:
    """Whether a stored block (resolved ``spec``, size-1 axes dropped)
    already is the compute block ``layout`` describes."""
    if layout is None:
        return not any(e is not None for e in spec)
    dim, _, block = layout
    return block and tuple(spec) in ((None,) * dim + (axis,),
                                     (None,) * dim + (axis, None))


def tp_params(params: Params, cfg: TransformerConfig, mesh, specs=None,
              axis: str = "mp", embed_full: bool = False) -> Params:
    """This rank's tensor-parallel compute blocks from its stored blocks
    ``params`` (each cut by its resolved spec in ``specs``; a name
    without one is whole).  A block already in its compute layout is kept;
    any other is all-gathered whole and cut again (QKV under
    :func:`transformer_partition_rules`: its column blocks are not
    head-aligned).  ``embed_full`` keeps the embeddings whole (training:
    the LM head runs against the whole ``tok_emb``); otherwise they are
    column blocks (serving: the head's partial logits are summed).  Not
    differentiable: the train step maps gradients back itself."""
    from .mesh import gather, sharding_for

    specs = specs or {}
    r, n = _mp_coords(mesh, axis)
    _tp_check(cfg, n, "tp_params")
    shapes = param_shapes(cfg)
    out = {}
    with torch.no_grad():
        for k, v in params.items():
            lay = _tp_layout(k, shapes.get(k, v.shape), cfg, r, n,
                             embed_full)
            spec = _live_spec(specs.get(k, ()), mesh)
            if _same_block(spec, lay, axis):
                out[k] = v
                continue
            whole = gather(v, sharding_for(mesh, *spec)) if spec else v
            out[k] = whole if lay is None else whole.index_select(
                lay[0], lay[1].to(whole.device)).contiguous()
    return out


def _tp_grads_to_storage(grads: Params, cfg: TransformerConfig, mesh,
                         specs, axis: str, embed_full: bool) -> Params:
    """Gradients in the compute layout -> this rank's stored blocks: a
    compute block of another layout is scattered into the whole shape and
    summed over ``axis`` (each rank holds only its part), a replicated
    one is already whole on every rank; then this rank's stored block is
    cut."""
    from .collectives import _psum
    from .mesh import shard, sharding_for

    r, n = _mp_coords(mesh, axis)
    shapes = param_shapes(cfg)
    out = {}
    for k, g in grads.items():
        lay = _tp_layout(k, shapes[k], cfg, r, n, embed_full)
        spec = _live_spec(specs.get(k, ()), mesh)
        if _same_block(spec, lay, axis):
            out[k] = g
            continue
        if lay is not None:
            whole = g.new_zeros(shapes[k])
            whole.index_copy_(lay[0], lay[1].to(g.device), g)
            g = _psum(whole, mesh.group(axis))
        out[k] = shard(g, sharding_for(mesh, *spec)) if spec else g
    return out


def _tp_ops(mesh, axis: str):
    """(enter, reduce, gather) of tensor parallelism over ``axis``: the
    identity on a mesh without it."""
    from .collectives import allgather_bcast, pcopy, psum_bcast

    if _mp_coords(mesh, axis)[1] == 1:
        return _identity, _identity, _identity
    return (functools.partial(pcopy, axis_name=axis, mesh=mesh),
            functools.partial(psum_bcast, axis_name=axis, mesh=mesh),
            functools.partial(allgather_bcast, axis_name=axis, axis=-1,
                              mesh=mesh))


def _tp_embed(params, tok_idx, pos_rows, cfg, gather):
    x = params["tok_emb"][tok_idx] + pos_rows
    return x if x.shape[-1] == cfg.d_model else gather(x)


def _tp_logits(x, params, cfg, mesh, axis, enter, reduce):
    """x @ tok_emb.T: against the whole table, or (a column block of
    it) this rank's slice of the features, the partial logits summed."""
    emb = params["tok_emb"]
    if emb.shape[1] == cfg.d_model:
        return x @ emb.T
    d = emb.shape[1]
    xl = enter(x).narrow(-1, mesh.axis_index(axis) * d, d)
    return reduce(xl @ emb.T)


def transformer_lm_apply_tp(params: Params, tokens, positions,
                            cfg: TransformerConfig, mesh, axis: str = "mp",
                            attention=None):
    """The tensor-parallel counterpart of :func:`transformer_lm_apply`:
    every rank calls it with its compute blocks (:func:`tp_params`) and
    the same ``tokens``/``positions``; the logits come out whole and
    equal on every rank.  Column-parallel QKV and MLP-in, row-parallel
    attention-out and MLP-out with one all-reduce each, attention over
    this rank's heads (default causal :func:`local_attention`).
    Differentiable: gradients reach each rank's blocks (those of the
    whole-array leaves are the same on every rank)."""
    if attention is None:
        attention = functools.partial(local_attention, causal=True)
    enter, reduce, gather = _tp_ops(mesh, axis)
    x = _tp_embed(params, tokens.long(),
                  params["pos_emb"][positions.long()][None], cfg, gather)
    for i in range(cfg.n_layers):
        x = _block(x, params, i, cfg.d_head,
                   lambda i, q, k, v: attention(q, k, v), enter, reduce)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return _tp_logits(x, params, cfg, mesh, axis, enter, reduce)


def transformer_lm_decode_tp(params: Params, tokens, positions, lengths,
                             k_pool, v_pool, block_tables,
                             cfg: TransformerConfig, mesh, rows,
                             axis: str = "mp", k_scale=None, v_scale=None):
    """The tensor-parallel counterpart of :func:`transformer_lm_decode`
    (paged kernel): each rank runs it with its compute blocks
    (:func:`tp_params`, column-block embeddings) over its head slice of
    the pool, ``(n_layers, num_blocks, block_size, n_heads / mp,
    d_head)`` (and of the int8 scales), written in place.  Every other
    operand is the same on every rank.  ``rows`` (B,) picks the position
    of each row whose logits are wanted (the sampled one) before the LM
    head, so the head's partial logits summed over ranks are (B, vocab);
    ``rows=None`` keeps every position, (B, T, vocab) (speculative
    verify).  Returns them f32, whole on every rank."""
    enter, reduce, gather = _tp_ops(mesh, axis)
    attend, tokens, pos64 = _decode_setup(
        tokens, positions, lengths, k_pool, v_pool, block_tables, cfg,
        "paged", k_scale, v_scale)
    x = _tp_embed(params, tokens, params["pos_emb"][pos64], cfg, gather)
    for i in range(cfg.n_layers):
        x = _block(x, params, i, cfg.d_head, attend, enter, reduce)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    if rows is not None:
        x = x[torch.arange(x.shape[0], device=x.device), rows.long()]
    return _tp_logits(x, params, cfg, mesh, axis, enter, reduce).float()


def make_partitioned_train_step(mesh, cfg: TransformerConfig, rules=None,
                                lr=0.1, momentum=0.9, compute_dtype=None,
                                mp_compute: Optional[bool] = None):
    """The dp x mp training step whose params and momenta are STORED
    sharded per partition rules (default
    :func:`transformer_partition_rules`).  Returns ``(step, shard_fn,
    gather_fn)``: ``shard_fn(whole)`` cuts this rank's blocks of a whole
    param dict (numpy or tensors), ``gather_fn(blocks)`` gives the whole
    dict back on every rank, and ``step(params, momenta, tokens, labels,
    positions) -> (loss, params, momenta)`` takes this rank's blocks of
    the params and momenta and of the batch (tokens and labels cut by
    ``P("dp")``; positions (T,) whole), and returns the global mean loss
    (f32, detached, the same on every rank) and this rank's new blocks
    (new tensors; the inputs untouched).

    Two routes, as in the reference:

    - **storage** (FSDP; ``mp_compute=False``, or a rule set carrying
      the ``FSDP`` sentinel): each rank all-gathers every sharded leaf,
      runs :func:`lm_loss` on its dp block, sums the gradients over
      ``dp`` only and keeps its own block.  ``mp`` carries shards, never
      replicas.
    - **compute** (tensor parallelism; the default when the rule set is
      compute-partitionable and ``TPUMX_MP_COMPUTE`` is not ``0``): each
      rank computes with its blocks through
      :func:`transformer_lm_apply_tp` (explicit differentiable
      collectives), its stored blocks moved into the compute layout
      first (:func:`tp_params`: QKV's columns all-gathered and cut again
      head-aligned, the embeddings gathered whole for the LM head), and
      the gradients moved back.  Needs ``n_heads`` and ``d_ff``
      divisible by ``mp``.

    The attention is :func:`lm_loss`'s default, as in the reference."""
    from .collectives import psum_flat
    from .mesh import gather, shard, sharding_for
    from .partition_rules import (make_param_specs,
                                  make_shard_and_gather_fns,
                                  mp_compute_enabled,
                                  rules_compute_partitionable)

    if rules is None:
        rules = transformer_partition_rules()
    if mp_compute is None:
        mp_compute = (mp_compute_enabled()
                      and rules_compute_partitionable(rules))
    shapes = param_shapes(cfg)
    specs = make_param_specs(rules, shapes, mesh, mp_axis="mp")
    shard_fn, gather_fn = make_shard_and_gather_fns(specs, mesh)
    dp = mesh.shape.get("dp", 1)
    dp_axes = ("dp",) if "dp" in mesh.shape else ()
    if mp_compute:
        _tp_check(cfg, _mp_coords(mesh, "mp")[1],
                  "make_partitioned_train_step")

    def update(params, momenta, grads):
        new_m = {k: momentum * momenta[k] + g for k, g in grads.items()}
        new_p = {k: params[k] - lr * new_m[k] for k in grads}
        return new_p, new_m

    live = {k: _live_spec(s, mesh) for k, s in specs.items()}
    live = {k: s for k, s in live.items() if s}

    def storage_step(params, momenta, tokens, labels, positions):
        with torch.no_grad():
            whole = {k: gather(v, sharding_for(mesh, *live[k]))
                     if k in live else v for k, v in params.items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in whole.items()}
        loss = lm_loss(leaves, tokens, labels, positions, cfg,
                       compute_dtype=compute_dtype) / dp
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            if dp_axes:
                *grads, loss = psum_flat([*grads, loss.detach()], dp_axes,
                                         mesh)
            grads = {k: shard(g, sharding_for(mesh, *live[k]))
                     if k in live else g for k, g in zip(leaves, grads)}
            new_p, new_m = update(params, momenta, grads)
        return loss.detach(), new_p, new_m

    def compute_step(params, momenta, tokens, labels, positions):
        comp = tp_params(params, cfg, mesh, specs, embed_full=True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in comp.items()}
        p = leaves if compute_dtype is None else {
            k: v.to(compute_dtype) for k, v in leaves.items()}
        dev = comp["tok_emb"].device
        logits = transformer_lm_apply_tp(
            p, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev), cfg, mesh)
        loss = _nll_mean(logits, labels) / dp
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            if dp_axes:
                *grads, loss = psum_flat([*grads, loss.detach()], dp_axes,
                                         mesh)
            grads = _tp_grads_to_storage(dict(zip(leaves, grads)), cfg, mesh,
                                         specs, "mp", embed_full=True)
            new_p, new_m = update(params, momenta, grads)
        return loss.detach(), new_p, new_m

    return (compute_step if mp_compute else storage_step), shard_fn, \
        gather_fn
