"""Single-device attention of the port.

PyTorch counterpart of ``mxnet_tpu/parallel/ring_attention.py``
``local_attention`` — the plain attention ``transformer_lm_apply`` uses.
The sequence-parallel ring comes with the distributed slice.
"""
from __future__ import annotations

import torch

__all__ = ["local_attention"]


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
