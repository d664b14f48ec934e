"""Paged attention over a block-table KV pool.

PyTorch counterpart of ``mxnet_tpu/ops/paged_attention.py``: the
``_paged_kernel`` (float pool) and ``_paged_kernel_q`` (int8 pool with
per-(block, head) f32 scales) Pallas kernels.  :func:`paged_attention`
walks each row's block table inside the hand-written CUDA kernels of
``csrc/paged_attention.cu`` for CUDA tensors; for CPU tensors it takes the
plain version, :func:`paged_attention_plain`, which gathers (and, for the
int8 pool, dequantizes) the row's context, widens it to f32 and runs
:func:`paged_attention_reference` (the gather+dense path of
``transformer_lm_decode``) with the kernel's block skipping folded into
the mask; on the f32 context the probabilities stay f32, as the TPU
kernels keep them.
A CUDA tensor the kernels do not take raises; nothing falls back.

Two routes, by the number of queries T (the ``.cu`` header has the
designs):

- decode (T <= 4): split-K flash-decoding.  The context is cut into spans
  of 128 positions (whole pool blocks); ``paged_decode_split_kernel``
  attends each span in a block of its own and writes an f32 partial
  ``(m, l, acc)`` to a workspace this wrapper allocates per call (torch's
  caching allocator, so the call stays capturable in a CUDA graph);
  ``paged_decode_merge_kernel`` combines a row's spans in span order, so
  the output repeats bit for bit.
- prefill (T > 4): ``paged_prefill_tile_kernel``, one block per 64-query
  tile, 64-key tiles assembled from the table through a cp.async ring.

Both keep the pool's dtype in shared memory.  The int8 pool's scales are
applied in the math, once a key: the score is ``k_scale * (q . k_int8)``
and the value sum takes ``(p * v_scale) * v_int8``.

Semantics shared by both: table entry 0 is the null block and is skipped,
as is every logical block past the row's last valid query position
``max_pos[b]`` — so block 0 and its scales are never read; a query attends
to cache positions ``<=`` its own; scores and accumulation are f32; a row
with no live block (``max_pos = -1``) comes out 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_plain", "paged_attention_sharded",
           "attention_scale"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_Q = [ctypes.c_void_p] * 2 + _ARGTYPES
_MAX_D = 128
# positions a decode block attends (the .cu file's kSpan), in whole pool
# blocks: the split kernel's grid and the workspace follow from it
_SPAN = 128


def decode_splits(W: int, block_size: int) -> int:
    """Spans the decode route cuts a table of ``W`` blocks into."""
    per = max(1, _SPAN // block_size)
    return -(-W // per)


def attention_scale(d_head: int) -> float:
    """1/sqrt(d) computed in f32 (a host f64 sqrt can differ in the last
    ulp from the f32 one the dense path uses)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_head)))


def paged_attention_reference(q, k_ctx, v_ctx, attn_mask, scale):
    """The gather+dense attend of ``transformer_lm_decode``.

    q: (B, T, H, D); k_ctx/v_ctx: (B, W*bs, H, D) gathered context;
    attn_mask: (B, T, W*bs) bool; scale: f32 scalar.  f32 scores and
    accumulation, masked slots at exactly 0 probability; the probabilities
    are rounded to the context's dtype before the value product, as in the
    reference."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_ctx.float()) * scale
    s = torch.where(attn_mask[:, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v_ctx.dtype).float(),
                     v_ctx.float())
    return o.to(q.dtype)


def paged_attention_plain(q, k_pool, v_pool, block_tables, positions,
                          max_pos, scale, k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`paged_attention`: gather every
    table entry's block (int8 pool: ``pool.float() * scale`` per block and
    head, as the reference's gather path dequantizes), zero the null and
    past-``max_pos`` blocks and mask them together with the causal bound,
    attend densely with :func:`paged_attention_reference`, zero the rows
    with no live block.  The context is widened to f32 first, exactly: the
    TPU kernels multiply f32 probabilities by f32-widened values, where
    the reference given a bf16 context rounds the probabilities to bf16
    (for f32 and int8 pools the widening changes nothing)."""
    B, T, H, D = q.shape
    bs = k_pool.shape[1]
    W = block_tables.shape[1]
    tables = block_tables.long()
    # (B, W, bs, H, D)
    k_ctx, v_ctx = k_pool[tables].float(), v_pool[tables].float()
    if k_scale is not None:
        k_ctx = k_ctx * k_scale[tables][:, :, None, :, None]
        v_ctx = v_ctx * v_scale[tables][:, :, None, :, None]
    starts = torch.arange(W, device=q.device) * bs
    live = (tables != 0) & (starts[None, :] <= max_pos.long()[:, None])
    # dead blocks are never read: whatever they hold (NaN included) is
    # replaced before it can reach a masked product
    zero = torch.zeros((), dtype=k_ctx.dtype, device=q.device)
    k_ctx = torch.where(live[:, :, None, None, None], k_ctx, zero)
    v_ctx = torch.where(live[:, :, None, None, None], v_ctx, zero)
    ctx_pos = torch.arange(W * bs, device=q.device)
    mask = (ctx_pos[None, None, :] <= positions.long()[:, :, None]) \
        & live.repeat_interleave(bs, dim=1)[:, None, :]
    o = paged_attention_reference(q, k_ctx.reshape(B, W * bs, H, D),
                                  v_ctx.reshape(B, W * bs, H, D), mask,
                                  scale)
    return torch.where(live.any(dim=1)[:, None, None, None], o,
                       torch.zeros((), dtype=o.dtype, device=o.device))


def paged_attention(q, k_pool, v_pool, block_tables, positions, max_pos,
                    scale=None, k_scale=None, v_scale=None):
    """Attention of ``q`` against one layer's paged KV pool.

    Parameters
    ----------
    q : (B, T, H, D) — this chunk's queries (T=1 decode, T=bucket prefill).
    k_pool, v_pool : (num_blocks, block_size, H, D) — ONE layer's pool,
        already holding this chunk's scattered K/V.
    block_tables : (B, W) int32 — physical block of each logical block;
        0 is the null sentinel.
    positions : (B, T) int32 — global position of each query.
    max_pos : (B,) int32 — last VALID query position per row (-1 for an
        inactive row, whose output is 0).
    scale : float, optional — softmax scale; default
        :func:`attention_scale` of D.
    k_scale, v_scale : (num_blocks, H) float32, optional — per-(block,
        head) dequantization scales of an int8 pool; given, the pools are
        int8 and the scales multiply each key's score and probability.

    Returns (B, T, H, D) in q's dtype.  CUDA tensors (contiguous; q
    float32 or bfloat16 with float pools of the same dtype, or int8 pools
    with their scales; D <= 128; indices int32) launch the CUDA kernels
    (decode: split and merge; prefill: the tile kernel), each call counted
    once in ``paged_attention.launches`` (float pool) or
    ``paged_attention.launches_int8`` (int8 pool); CPU tensors take
    :func:`paged_attention_plain`.
    """
    B, T, H, D = q.shape
    if scale is None:
        scale = attention_scale(D)
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise MXNetError("paged_attention: pass both k_scale and v_scale "
                         "or neither")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     positions, max_pos, scale, k_scale,
                                     v_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise MXNetError(f"paged_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    W = block_tables.shape[1]
    pool_dtype = torch.int8 if quantized else q.dtype
    expect = [
        ("k_pool", k_pool, (nb, bs, H, D), pool_dtype),
        ("v_pool", v_pool, (nb, bs, H, D), pool_dtype),
        ("block_tables", block_tables, (B, W), torch.int32),
        ("positions", positions, (B, T), torch.int32),
        ("max_pos", max_pos, (B,), torch.int32),
    ]
    if quantized:
        expect += [("k_scale", k_scale, (nb, H), torch.float32),
                   ("v_scale", v_scale, (nb, H), torch.float32)]
    for name, t, shape, dtype in expect:
        if t.device != q.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise MXNetError(
                f"paged_attention: {name} must be a contiguous {shape} "
                f"{dtype} tensor on {q.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if not q.is_contiguous():
        raise MXNetError("paged_attention: q must be contiguous")
    if D > _MAX_D:
        raise MXNetError(f"paged_attention: head dim {D} > {_MAX_D}")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    splits = decode_splits(W, bs)
    ws = (torch.empty(B * H * splits * T * (D + 2), dtype=torch.float32,
                      device=q.device) if T <= 4 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (block_tables.data_ptr(), positions.data_ptr(),
            max_pos.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, T, H, D, bs, W,
            splits, float(scale), _DTYPES[q.dtype], stream)
    if quantized:
        fn = _build.kernel_function("paged_attention",
                                    "tpumx_paged_attention_q", _ARGTYPES_Q)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        _build.check_launch(rc, "paged_attention (int8 pool)")
        paged_attention.launches_int8 += 1
    else:
        fn = _build.kernel_function("paged_attention",
                                    "tpumx_paged_attention", _ARGTYPES)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *tail)
        _build.check_launch(rc, "paged_attention")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.launches_int8 = 0


def paged_attention_sharded(q, k_pool, v_pool, block_tables, positions,
                            max_pos, mesh, axis: str = "mp", scale=None,
                            k_scale=None, v_scale=None):
    """:func:`paged_attention` partitioned PER HEAD over a model-parallel
    mesh axis: whole arrays in on every rank (q and the pools with heads
    at dim 2, the int8 pool's ``(num_blocks, H)`` scales with heads at
    dim 1), each rank runs the unchanged kernel on its head slice, and
    the whole (B, T, H, D) output comes back on every rank (all-gathered
    over the heads).  Heads are independent in the kernel, so a head's
    output is bitwise the unsharded call's.  ``H % mesh.shape[axis] != 0``
    raises ``MXNetError``.  Tensor-parallel decode
    (``parallel.transformer.transformer_lm_decode_tp``) runs the per-rank
    part of this on the head slice its pool holds."""
    from ..parallel.mesh import gather, sharding_for

    H = q.shape[2]
    n = int(mesh.shape[axis])
    if H % n:
        raise MXNetError(
            f"paged_attention_sharded: {H} heads not divisible by mesh "
            f"axis {axis!r} of size {n}")
    if scale is None:
        scale = attention_scale(q.shape[3])
    h = H // n
    first = mesh.axis_index(axis) * h
    heads = lambda t, dim: None if t is None else \
        t.narrow(dim, first, h).contiguous()  # noqa: E731
    out = paged_attention(heads(q, 2), heads(k_pool, 2), heads(v_pool, 2),
                          block_tables, positions, max_pos, scale=scale,
                          k_scale=heads(k_scale, 1), v_scale=heads(v_scale, 1))
    return gather(out, sharding_for(mesh, None, None, axis, None))
