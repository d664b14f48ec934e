"""Paged attention over a block-table KV pool — kernel 2 of the serving slice.

PyTorch counterpart of ``mxnet_tpu/ops/paged_attention.py`` (the
``_paged_kernel`` Pallas kernel, float-pool path).  :func:`paged_attention`
walks each row's block table inside the hand-written CUDA kernel
``csrc/paged_attention.cu`` for CUDA tensors; for CPU tensors it takes the
plain version, :func:`paged_attention_plain`, which gathers the row's
context and runs :func:`paged_attention_reference` (the gather+dense path
of ``transformer_lm_decode``) with the kernel's block-skipping folded into
the mask.  A CUDA tensor the kernel does not take raises; nothing falls
back.

Semantics shared by both: table entry 0 is the null block and is skipped,
as is every logical block past the row's last valid query position
``max_pos[b]``; a query attends to cache positions ``<=`` its own; scores
and accumulation are f32; a row with no live block (``max_pos = -1``)
comes out 0.  The int8-pool variant (``k_scale``/``v_scale``) comes with
a later slice.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_plain", "attention_scale"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SMEM_LIMIT = 227 * 1024
_MAX_D = 128


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
                          max_pos, scale):
    """Plain PyTorch version of :func:`paged_attention`: gather every
    table entry's block, mask the null and past-``max_pos`` blocks together
    with the causal bound, attend densely, zero the rows with no live
    block."""
    B, T, H, D = q.shape
    bs = k_pool.shape[1]
    W = block_tables.shape[1]
    tables = block_tables.long()
    k_ctx = k_pool[tables].reshape(B, W * bs, H, D)
    v_ctx = v_pool[tables].reshape(B, W * bs, H, D)
    starts = torch.arange(W, device=q.device) * bs
    live = (tables != 0) & (starts[None, :] <= max_pos.long()[:, None])
    ctx_pos = torch.arange(W * bs, device=q.device)
    mask = (ctx_pos[None, None, :] <= positions.long()[:, :, None]) \
        & live.repeat_interleave(bs, dim=1)[:, None, :]
    o = paged_attention_reference(q, k_ctx, v_ctx, mask, scale)
    return torch.where(live.any(dim=1)[:, None, None, None], o,
                       torch.zeros((), dtype=o.dtype, device=o.device))


def paged_attention(q, k_pool, v_pool, block_tables, positions, max_pos,
                    scale=None):
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

    Returns (B, T, H, D) in q's dtype.  CUDA tensors (contiguous; q and
    pools float32 or bfloat16 alike; D <= 128; indices int32) launch the
    CUDA kernel, counted in ``paged_attention.launches``; CPU tensors take
    :func:`paged_attention_plain`.
    """
    B, T, H, D = q.shape
    if scale is None:
        scale = attention_scale(D)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     positions, max_pos, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise MXNetError(f"paged_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    W = block_tables.shape[1]
    expect = (
        ("k_pool", k_pool, (nb, bs, H, D), q.dtype),
        ("v_pool", v_pool, (nb, bs, H, D), q.dtype),
        ("block_tables", block_tables, (B, W), torch.int32),
        ("positions", positions, (B, T), torch.int32),
        ("max_pos", max_pos, (B,), torch.int32),
    )
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
    if T <= 4:   # decode kernel: a K/V tile per warp plus merge buffers
        smem = 4 * (4 * bs * (2 * D + 1) + 20 * D + 32)
    else:        # prefill kernel: one K/V tile plus 16 queries
        smem = 4 * (bs * (2 * D + 1) + 16 * D)
    if smem > _SMEM_LIMIT:
        raise MXNetError(
            f"paged_attention: block_size {bs} x head dim {D} needs {smem} "
            f"bytes of shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn = _build.kernel_function("paged_attention", "tpumx_paged_attention",
                                _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), max_pos.data_ptr(),
            out.data_ptr(), B, T, H, D, bs, W, float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
