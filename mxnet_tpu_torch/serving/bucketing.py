"""Shape bucketing and padding helpers for the serving layer.

PyTorch-port copy of ``mxnet_tpu/serving/bucketing.py`` (the ladder
helpers the generation engine uses).  The port runs eagerly, but it keeps
the reference's fixed ladders: they bound the set of step shapes a
service ever runs (what a later CUDA-graph capture will key on) and keep
the two packages' schedules identical.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as _np

__all__ = ["batch_buckets", "bucket_batch", "seq_buckets", "bucket_seq_len",
           "pad_tokens_right"]


def batch_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to and including ``max_batch_size`` (the cap
    itself is kept even when not a power of two)."""
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b <<= 1
    out.append(int(max_batch_size))
    return out


def bucket_batch(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket when none fits."""
    for b in buckets:
        if b >= n:
            return int(b)
    return int(buckets[-1])


def seq_buckets(max_seq_len: int, min_bucket: int = 16) -> List[int]:
    """Powers of two from ``min_bucket`` up to and including
    ``max_seq_len`` (the cap itself kept, like :func:`batch_buckets`)."""
    max_seq_len = int(max_seq_len)
    if max_seq_len < 1:
        raise ValueError("max_seq_len must be >= 1")
    out: List[int] = []
    b = min(int(min_bucket), max_seq_len)
    while b < max_seq_len:
        out.append(b)
        b <<= 1
    out.append(max_seq_len)
    return out


def bucket_seq_len(t: int, buckets: Sequence[int]) -> int:
    """Smallest seq-len bucket >= t; a t beyond the largest bucket raises
    ``ValueError`` (an over-long sequence cannot be truncated without
    changing the result)."""
    t = int(t)
    if t < 1:
        raise ValueError(f"sequence length must be >= 1, got {t}")
    for b in buckets:
        if b >= t:
            return int(b)
    raise ValueError(
        f"sequence length {t} exceeds the largest configured bucket "
        f"{max(buckets)}; raise the bucket ladder (or max_len) to serve it")


def pad_tokens_right(tokens, bucket: int, pad_id: int = 0) -> _np.ndarray:
    """Right-pad a 1-D token sequence to ``bucket`` with ``pad_id``."""
    arr = _np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(
            f"expected a 1-D token sequence, got shape {arr.shape}")
    if arr.shape[0] > int(bucket):
        raise ValueError(f"cannot pad {arr.shape[0]} tokens down to {bucket}")
    if arr.shape[0] == int(bucket):
        return arr
    return _np.pad(arr, (0, int(bucket) - arr.shape[0]), mode="constant",
                   constant_values=pad_id)
