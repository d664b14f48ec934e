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

The host side is :class:`BlockAllocator`, a refcounted free list.  Under
this slice the engine reserves each request's worst case at admission
(the reference's ``preemption=False`` accounting); incremental allocation
with preemption, prefix sharing and the int8 pool come with later slices.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

__all__ = ["BlockAllocator", "PagedKVCache", "blocks_for"]


def blocks_for(n_positions: int, block_size: int) -> int:
    """Number of cache blocks covering ``n_positions`` tokens."""
    return max(1, -(-int(n_positions) // int(block_size)))


class BlockAllocator:
    """Free-list allocator over physical block ids ``1..num_blocks-1``
    (block 0 is the reserved null block).  Thread-safe; all-or-nothing
    allocation so a request is never half-admitted.  Every allocated block
    carries a refcount (born 1); it returns to the free list when its last
    reference is released."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        # pop() takes from the tail: hand out low ids first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - self.num_free

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

    def free(self, blocks: List[int]) -> List[int]:
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

    def refcount(self, block: int) -> int:
        """Live reference count of a block (0 = free)."""
        with self._lock:
            return self._ref.get(int(block), 0)

    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently owned by requests."""
        total = self.num_blocks - 1
        return self.num_used / total if total else 0.0


class PagedKVCache:
    """The device-side pool (``k``/``v`` tensors on ``device``) plus the
    allocator that parcels their blocks out to requests."""

    def __init__(self, n_layers: int, n_heads: int, d_head: int,
                 num_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        shape = (int(n_layers), self.num_blocks, self.block_size,
                 int(n_heads), int(d_head))
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = BlockAllocator(self.num_blocks)

    @property
    def shape(self):
        return tuple(self.k.shape)
