"""Paged KV-cache pool and host-side block allocator.

PyTorch counterpart of ``mxnet_tpu/serving/generation/kv_cache.py``
(vLLM's PagedAttention memory model).  The device side is two
preallocated tensors of shape ``(n_layers, num_blocks, block_size,
n_heads, d_head)`` — K and V, in the JAX package's layout — whose shapes
never change for the life of the engine; the model step writes them in
place.  A request owns a list of physical blocks (its block table);
logical position ``p`` lives at ``(table[p // block_size], p %
block_size)``.  Block 0 is the null/scratch block: padded prefill
positions and inactive decode slots write there.

The host side is :class:`BlockAllocator`, a refcounted free list with a
high/low occupancy watermark pair.  The engine's default accounting is
incremental (allocate-as-you-decode): admission takes the blocks the
current context needs, a decode that crosses a block boundary takes one
more, and pool pressure preempts victim requests back to the queue
(``preemption=False`` restores reserve-ahead admission).  Refcounts carry
prefix-cache sharing: a block frees only when its last owner lets go.

``kv_dtype="int8"`` stores the pool quantized: int8 K/V with symmetric
per-``(layer, block, head)`` f32 scales in ``k_scale``/``v_scale``, about
half the bytes of a bf16 pool (:meth:`PagedKVCache.num_blocks_for_bytes`).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["BlockAllocator", "PagedKVCache", "blocks_for"]


def blocks_for(n_positions: int, block_size: int) -> int:
    """Number of cache blocks covering ``n_positions`` tokens."""
    return max(1, -(-int(n_positions) // int(block_size)))


def _check_watermarks(high: float, low: float) -> None:
    if not (0.0 < low <= high <= 1.0):
        raise ValueError(
            f"watermarks must satisfy 0 < low <= high <= 1, got "
            f"low={low}, high={high}")


class BlockAllocator:
    """Free-list allocator over physical block ids ``1..num_blocks-1``
    (block 0 is the reserved null block).  Thread-safe; all-or-nothing
    allocation so a request is never half-admitted.

    Every allocated block carries a refcount (born 1): :meth:`incref`
    marks a sharer, :meth:`decref`/:meth:`free` release one reference and
    the block returns to the free list only at zero.  ``watermark_high`` /
    ``watermark_low`` are occupancy fractions the preempting engine steers
    by; the allocator only reports them (:meth:`above_high`,
    :meth:`above_low`)."""

    def __init__(self, num_blocks: int, watermark_high: float = 1.0,
                 watermark_low: float = 1.0):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        _check_watermarks(watermark_high, watermark_low)
        self.num_blocks = int(num_blocks)
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self._lock = threading.Lock()
        # pop() takes from the tail: hand out low ids first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    def set_watermarks(self, high: float, low: float) -> None:
        _check_watermarks(high, low)
        self.watermark_high, self.watermark_low = float(high), float(low)

    def above_high(self) -> bool:
        """Occupancy strictly above the high watermark (preemption due)."""
        return self.occupancy() > self.watermark_high

    def above_low(self) -> bool:
        """Occupancy strictly above the low watermark (keep preempting)."""
        return self.occupancy() > self.watermark_low

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - self.num_free

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= int(n)

    def allocate(self, n: int) -> Optional[List[int]]:
        """``n`` blocks (refcount 1 each), or None (nothing taken) if
        fewer are free."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if len(self._free) < n:
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
        return out

    def incref(self, blocks: List[int]) -> None:
        """Add one reference to each allocated block (a sharer, such as a
        prefix-cache hit, now also holds it)."""
        with self._lock:
            for b in blocks:
                if int(b) not in self._ref:
                    raise ValueError(f"incref of unallocated block {int(b)}")
            for b in blocks:
                self._ref[int(b)] += 1

    def decref(self, blocks: List[int]) -> List[int]:
        """Release one reference per block; blocks reaching zero return to
        the free list.  Returns the block ids actually freed."""
        freed: List[int] = []
        with self._lock:
            for b in blocks:
                b = int(b)
                if b <= 0 or b >= self.num_blocks:
                    raise ValueError(f"block id {b} out of range")
                if b not in self._ref:
                    raise ValueError(f"double free of block {b}")
            for b in blocks:
                b = int(b)
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    del self._ref[b]
                    self._free.append(b)
                    freed.append(b)
        return freed

    def free(self, blocks: List[int]) -> None:
        """Release one reference per block (alias of :meth:`decref`: a
        block truly frees only when its last owner lets go)."""
        self.decref(blocks)

    def refcount(self, block: int) -> int:
        """Live reference count of a block (0 = free)."""
        with self._lock:
            return self._ref.get(int(block), 0)

    @property
    def num_shared(self) -> int:
        """Blocks currently held by more than one owner."""
        with self._lock:
            return sum(1 for c in self._ref.values() if c >= 2)

    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently owned."""
        total = self.num_blocks - 1
        return self.num_used / total if total else 0.0


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """The device-side pool (``k``/``v`` tensors on ``device``, plus
    ``k_scale``/``v_scale`` for the int8 pool) and the allocator that
    parcels their blocks out to requests.

    ``dtype`` is the compute dtype (the float pool's storage dtype);
    ``kv_dtype="int8"`` stores K/V as int8 with ``(n_layers, num_blocks,
    n_heads)`` f32 scales, initialised to 1: unwritten blocks dequantize
    to bounded values, and the first real write recomputes a block's
    scale from scratch.

    ``mp > 1`` (model-parallel serving): this process holds only its
    rank's head slice of the pool, ``(n_layers, num_blocks, block_size,
    n_heads / mp, d_head)``, and of the scales, ``(n_layers, num_blocks,
    n_heads / mp)`` — 1/mp of the cache a card; :attr:`shape` stays the
    whole pool's."""

    def __init__(self, n_layers: int, n_heads: int, d_head: int,
                 num_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 kv_dtype: Optional[str] = None, mp: int = 1):
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if int(n_heads) % int(mp):
            raise ValueError(f"{n_heads} heads do not split over mp={mp}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self._shape = (int(n_layers), self.num_blocks, self.block_size,
                       int(n_heads), int(d_head))
        n_heads = int(n_heads) // int(mp)
        shape = (int(n_layers), self.num_blocks, self.block_size,
                 int(n_heads), int(d_head))
        store = torch.int8 if kv_dtype == "int8" else dtype
        self.k = torch.zeros(shape, dtype=store, device=device)
        self.v = torch.zeros(shape, dtype=store, device=device)
        if kv_dtype == "int8":
            sshape = (int(n_layers), self.num_blocks, int(n_heads))
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
        else:
            self.k_scale = None
            self.v_scale = None
        self.allocator = BlockAllocator(self.num_blocks)

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def shape(self):
        """The whole pool's shape (a model-parallel rank holds a head
        slice of it: ``k.shape``)."""
        return self._shape

    def nbytes(self) -> int:
        """Bytes this process stores: K, V and the int8 pool's scales."""
        ts = [self.k, self.v, self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def blocks_for(self, n_positions: int) -> int:
        return blocks_for(n_positions, self.block_size)

    def max_positions(self) -> int:
        """Positions one request could address if it owned every block."""
        return (self.num_blocks - 1) * self.block_size

    def snapshot_blocks(self, blocks: List[int]) -> Dict[str, np.ndarray]:
        """Bit snapshot of the given physical blocks (K, V and, for the
        int8 pool, their scales) as host numpy arrays."""
        idx = torch.as_tensor([int(b) for b in blocks], dtype=torch.long,
                              device=self.k.device)
        host = lambda t: t[:, idx].cpu().numpy()  # noqa: E731
        out = {"k": host(self.k), "v": host(self.v)}
        if self.quantized:
            out["k_scale"] = host(self.k_scale)
            out["v_scale"] = host(self.v_scale)
        return out

    def nbytes(self) -> int:
        tensors = [self.k, self.v]
        if self.quantized:
            tensors += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in tensors)

    @staticmethod
    def bytes_per_block(n_layers: int, n_heads: int, d_head: int,
                        block_size: int, dtype=None,
                        kv_dtype: Optional[str] = None) -> int:
        """Device bytes one pool block costs (K + V + scales)."""
        item = 1 if kv_dtype == "int8" else _itemsize(
            dtype if dtype is not None else torch.float32)
        per = 2 * n_layers * block_size * n_heads * d_head * item
        if kv_dtype == "int8":
            per += 2 * n_layers * n_heads * 4  # f32 k/v scales
        return per

    @classmethod
    def num_blocks_for_bytes(cls, pool_bytes: int, n_layers: int,
                             n_heads: int, d_head: int, block_size: int,
                             dtype=None,
                             kv_dtype: Optional[str] = None) -> int:
        """How many blocks a byte budget buys: at identical ``pool_bytes``
        the int8 pool's budget is ~2x the bf16 one."""
        return int(pool_bytes) // cls.bytes_per_block(
            n_layers, n_heads, d_head, block_size, dtype, kv_dtype)
