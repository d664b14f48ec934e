"""Ring attention: exact blockwise attention over a sequence-sharded axis,
and the single-device attention of the port.

PyTorch counterpart of ``mxnet_tpu/parallel/ring_attention.py``.  Q/K/V
are sharded on the sequence dimension over the ``sp`` axis; each rank
keeps its q block while the k/v blocks rotate n - 1 hops around the ring
(``collectives.ppermute``), and merges each block's partial attention into
a running softmax (m/l accumulators, log-sum-exp algebra).  The causal
bias of each block comes from the global positions of the q block (this
rank's) and of the k/v block it holds at that hop (rank - hop, mod n).

Shapes (per rank): q, k, v: (B, T_local, H, D).  Scores and accumulators
are f32; the probabilities meet v in v's dtype, as the reference's
``p.astype(v.dtype)`` does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .collectives import axis_index, axis_size, ppermute, shard_map_compat
from .mesh import Mesh, PartitionSpec, get_mesh

__all__ = ["ring_attention", "ring_attention_sharded", "local_attention"]


def _scale(q, scale):
    if scale is not None:
        return scale
    # the reference's 1 / sqrt(d) with sqrt(d) rounded to q's dtype
    return 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(
        q.dtype).float()


def _block_attn(q, k, v, bias=None, scale=None):
    """One q-block x kv-block partial attention: (unnormalized out, running
    max m, running denominator l), f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _bh_to_bqh(x):
    # (B, H, Tq) -> (B, Tq, H, 1) to scale (B, Tq, H, D)
    return x.transpose(1, 2)[..., None]


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two partial softmax accumulations."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * _bh_to_bqh(a1) + o2 * _bh_to_bqh(a2), m, l1 * a1 + l2 * a2


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Call on each rank's sequence blocks with ``axis_name`` bound
    (``collectives.spmd``); exact attention over the whole sequence."""
    n = axis_size(axis_name)
    rank = axis_index(axis_name)
    tq, tk = q.shape[1], k.shape[1]
    dev = q.device

    def bias_for(step):
        if not causal:
            return None
        kv_rank = (rank - step) % n
        q_pos = rank * tq + torch.arange(tq, device=dev)
        k_pos = kv_rank * tk + torch.arange(tk, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]
        return torch.where(mask, 0.0, -1e30)[None, None]

    o, m, l = _block_attn(q, k, v, bias_for(0), scale)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k, v
    for i in range(1, n):
        k_cur = ppermute(k_cur, axis_name, perm)
        v_cur = ppermute(v_cur, axis_name, perm)
        o, m, l = _merge(o, m, l, *_block_attn(q, k_cur, v_cur,
                                               bias_for(i), scale))
    return (o / _bh_to_bqh(l)).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh: Optional[Mesh] = None,
                           axis_name: str = "sp", causal: bool = False):
    """Host-level entry: whole q, k, v in, sharded over the sequence on
    ``axis_name``, the ring run, the whole output back on every rank."""
    mesh = mesh or get_mesh()
    spec = PartitionSpec(None, axis_name, None, None)
    fn = shard_map_compat(
        functools.partial(ring_attention, axis_name=axis_name, causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check=False)
    return fn(q, k, v)


def local_attention(q, k, v, causal: bool = False, scale=None):
    """Single-device reference attention over (B, T, H, D) tensors: f32
    scores and accumulation, masked slots at exactly 0 probability, the
    output in q's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tq, device=q.device)[:, None] \
            >= torch.arange(tk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
