"""Token-sampling functions for autoregressive generation.

PyTorch counterpart of ``mxnet_tpu/ops/sampling.py`` (the functional core
the generation engine runs inside every model step).  Every knob is a
per-row tensor, so one call serves any mix of greedy / temperature /
top-k / top-p rows in a decode batch.

Conventions (the reference's, vLLM/HF-compatible):
- ``temperature <= 0`` means greedy (argmax of the raw logits);
- ``top_k <= 0`` or ``top_k >= vocab`` disables top-k; ties at the k-th
  logit are kept (a value threshold, not a rank cut);
- ``top_p >= 1`` disables nucleus filtering; the kept set is the smallest
  probability-sorted prefix whose mass reaches ``top_p`` (rank 0 always
  kept);
- sampling is Gumbel-max over the filtered, temperature-scaled logits.

Randomness is bit-compatible with the reference: a row's key is JAX's
``fold_in(PRNGKey(seed), counter)`` and its Gumbel noise is
``jax.random.gumbel`` under the partitionable threefry layout, both
reproduced here in integer torch ops (int64 masked to 32 bits) — so a
request's sampled tokens depend only on its seed and position, and match
the JAX package's for the same logits.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["temperature_scale", "top_k_mask", "top_p_mask", "sample_logits",
           "fold_keys", "threefry2x32", "gumbel", "NEG_INF"]

#: the finite -inf stand-in the attention masks use
NEG_INF = -1e30

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rows(v, like, dtype):
    """``v`` (scalar, numpy or tensor) as a ``like.shape[:-1]`` tensor."""
    t = torch.as_tensor(v, dtype=dtype, device=like.device)
    return torch.broadcast_to(t, like.shape[:-1])


def temperature_scale(logits, temperature):
    """``logits / temperature`` per row; rows with ``temperature <= 0``
    pass through unscaled."""
    logits = logits.float()
    t = _rows(temperature, logits, torch.float32)[..., None]
    pos = t > 0
    return torch.where(pos, logits / torch.where(pos, t, 1.0), logits)


def top_k_mask(logits, k):
    """Mask all but the top-k logits per row to :data:`NEG_INF`;
    ``k <= 0`` or ``k >= vocab`` keeps the row.  Ties with the k-th value
    are kept."""
    logits = logits.float()
    vocab = logits.shape[-1]
    kk = _rows(k, logits, torch.int64)
    kk = torch.where((kk <= 0) | (kk > vocab), vocab, kk)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(sorted_desc, -1, (kk - 1)[..., None])
    return torch.where(logits >= thresh, logits, NEG_INF)


def top_p_mask(logits, p):
    """Nucleus filtering: keep the smallest probability-sorted prefix with
    cumulative mass >= ``p``; rank 0 is always kept; ``p >= 1``
    disables."""
    logits = logits.float()
    pp = _rows(p, logits, torch.float32)[..., None]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    rank0 = torch.arange(logits.shape[-1], device=logits.device) == 0
    keep = (exclusive < pp) | rank0
    count = keep.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_desc, -1, count - 1)
    return torch.where(logits >= thresh, logits, NEG_INF)


def _u32(v, device):
    """uint32 values (numpy, Python or tensor) as an int64 tensor."""
    if isinstance(v, torch.Tensor):
        t = v.long()
    else:
        t = torch.from_numpy(np.asarray(v).astype(np.int64))
    return (t if device is None else t.to(device)) & _M32


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors —
    JAX's ``threefry2x32_p``, term for term.  All four arguments broadcast;
    returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_keys(seeds, counters):
    """Per-row keys ``fold_in(PRNGKey(seed), counter)`` as a (B, 2) int64
    tensor of uint32 words — a request's randomness depends only on its
    own seed and the position being sampled."""
    seeds = _u32(seeds, None)
    counters = _u32(counters, seeds.device)
    zero = torch.zeros_like(seeds)
    # PRNGKey(s) = (0, s); fold_in hashes the counter block (0, c)
    y0, y1 = threefry2x32(zero, seeds, zero, counters)
    return torch.stack([y0, y1], dim=-1)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,))`` for each row key of ``keys``
    (B, 2): partitionable threefry bits ``hash(key, (0, i))``, xor of the
    two words, mantissa trick to a uniform in [tiny, 1), then
    ``-log(-log(u))``.  Returns (B, n) float32."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)[None, :]
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(idx),
                          idx)
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    u = torch.maximum(tiny, floats * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def sample_logits(logits, seeds, counters, temperature, top_k, top_p):
    """One sampling step over a batch of logit rows.

    logits (B, V); seeds/counters/temperature/top_k/top_p all (B,).
    Rows with ``temperature <= 0`` take the raw argmax (greedy); the rest
    apply top-k, then top-p, then temperature, then a Gumbel-max draw.
    Returns int64 token ids (B,)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    filtered = top_p_mask(top_k_mask(logits, top_k), top_p)
    scaled = temperature_scale(filtered, temperature)
    keys = fold_keys(_u32(seeds, logits.device),
                     _u32(counters, logits.device))
    sampled = torch.argmax(scaled + gumbel(keys, logits.shape[-1]), dim=-1)
    t = _rows(temperature, logits, torch.float32)
    return torch.where(t > 0, sampled, greedy)
