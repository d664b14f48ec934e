"""Shape bucketing and padding helpers for the serving layer.

PyTorch-port copy of ``mxnet_tpu/serving/bucketing.py``.  The port runs
eagerly, but it keeps the reference's fixed ladders: they bound the set of
shapes a service ever runs (one bound executor per bucket in
``InferenceService``, one CUDA-graph capture per signature in generation)
and keep the two packages' schedules identical.  ``Module.predict`` pads
an odd-sized final batch up to the bound batch with
:func:`pad_batch_rows` instead of rebinding for it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as _np

__all__ = ["next_pow2", "batch_buckets", "bucket_batch", "bucket_shape",
           "pad_sample", "pad_batch_rows", "assemble_batch",
           "seq_buckets", "bucket_seq_len", "pad_tokens_right"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


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


def bucket_shape(shape: Tuple[int, ...],
                 shape_buckets: Optional[Iterable[Tuple[int, ...]]] = None
                 ) -> Tuple[int, ...]:
    """A per-sample shape's bucket: with ``shape_buckets`` the smallest
    same-rank bucket that fits (every dim >= the sample's); otherwise each
    dim rounded up to the next power of two."""
    shape = tuple(int(d) for d in shape)
    if shape_buckets:
        fits = [tuple(int(d) for d in b) for b in shape_buckets
                if len(b) == len(shape)
                and all(bd >= sd for bd, sd in zip(b, shape))]
        if fits:
            return min(fits, key=lambda b: (_np.prod(b, dtype=_np.int64), b))
    return tuple(next_pow2(d) for d in shape)


def pad_sample(arr: _np.ndarray, target_shape: Tuple[int, ...]) -> _np.ndarray:
    """Zero-pad the trailing region of every dim up to ``target_shape``
    (models for which zeros are not neutral register exact shape buckets
    instead)."""
    if tuple(arr.shape) == tuple(target_shape):
        return arr
    if arr.ndim != len(target_shape):
        raise ValueError(f"rank mismatch padding {arr.shape} -> {target_shape}")
    pad = [(0, int(t) - int(s)) for s, t in zip(arr.shape, target_shape)]
    if any(p[1] < 0 for p in pad):
        raise ValueError(f"cannot pad {arr.shape} down to {target_shape}")
    return _np.pad(arr, pad, mode="constant")


def pad_batch_rows(arr: _np.ndarray, target_batch: int) -> _np.ndarray:
    """Pad axis 0 up to ``target_batch`` by repeating the final row (a real
    sample keeps the filler in distribution; the rows are dropped after
    the forward)."""
    n = arr.shape[0]
    if n == int(target_batch):
        return arr
    if n > int(target_batch):
        raise ValueError(f"cannot pad batch {n} down to {target_batch}")
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    filler = _np.repeat(arr[-1:], int(target_batch) - n, axis=0)
    return _np.concatenate([arr, filler], axis=0)


def assemble_batch(samples: Sequence[_np.ndarray],
                   sample_bucket: Tuple[int, ...],
                   batch_bucket: int) -> _np.ndarray:
    """Stack per-request samples into one batch: each sample zero-padded
    to the sample bucket, the stack row-padded to the batch bucket."""
    stacked = _np.stack([pad_sample(_np.asarray(s), sample_bucket)
                         for s in samples], axis=0)
    return pad_batch_rows(stacked, batch_bucket)
