"""Prefix-cache index: longest-prefix reuse of resident KV blocks.

PyTorch-port copy of ``mxnet_tpu/serving/generation/prefix_cache.py``
(pure host code, so it is the same code; kept here so the port never
imports the JAX package).  PagedAttention block sharing (vLLM) with
radix-style longest-prefix matching (SGLang RadixAttention): prompt
tokens are hashed per block-sized chunk with a chained hash, so a chunk's
key commits to its entire prefix — two prompts share a cache entry iff
they are token-for-token identical up to and including that block.  The
index maps chain keys to physical blocks of the
:class:`~.kv_cache.PagedKVCache` pool that already hold those tokens'
K/V, holding one allocator reference per indexed block (the "cache-only"
reference): a block stays resident after its last request finishes, ready
for the next admission to ``incref`` and reuse, and frees only when the
index evicts it.

Sharing discipline:

- only full blocks are indexed — a partially written tail block is still
  being appended to by its owner;
- indexed blocks are read-only to sharers: the engine copies any block
  with ``refcount > 1`` before scattering into it
  (``GenerationPrograms.copy_block``);
- eviction is LRU over cache-only leaves (refcount held solely by the
  index, no indexed children); the engine runs it ahead of victim
  preemption.

The index never touches the device: matching, insertion and eviction are
host arithmetic plus refcount bookkeeping.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as _np

__all__ = ["PrefixCacheIndex", "chain_hash", "ROOT_KEY"]

#: the chain-hash seed: the key of the empty prefix
ROOT_KEY = b"tpumx-prefix-root"


def chain_hash(prev: bytes, chunk) -> bytes:
    """Key of one block-sized token chunk, chained on its prefix's key —
    ``H(prev || tokens)`` (blake2b, 16-byte digest, tokens as int32)."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(_np.ascontiguousarray(
        _np.asarray(chunk, dtype=_np.int32)).tobytes())
    return h.digest()


class _Entry:
    __slots__ = ("key", "block", "parent", "children", "tick")

    def __init__(self, key: bytes, block: int, parent: Optional["_Entry"],
                 tick: int):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = 0  # indexed child entries (chain continuation)
        self.tick = tick   # LRU recency


class PrefixCacheIndex:
    """Chain-keyed longest-prefix index over resident pool blocks.

    Parameters
    ----------
    allocator : :class:`~.kv_cache.BlockAllocator`
        The pool's allocator — the index holds one reference per indexed
        block and releases it at eviction.
    block_size : int
        Tokens per block (the chunk size of the chain hash).
    capacity_blocks : int
        Cap on indexed blocks; 0 = bounded only by the pool and eviction.
    """

    def __init__(self, allocator, block_size: int,
                 capacity_blocks: int = 0):
        if int(block_size) < 1:
            raise ValueError("block_size must be >= 1")
        self._alloc = allocator
        self._bs = int(block_size)
        self._cap = max(0, int(capacity_blocks))
        self._lock = threading.Lock()
        self._entries: Dict[bytes, _Entry] = {}
        self._tick = 0
        self.evictions = 0   # cumulative blocks dropped from the index
        self.insertions = 0  # cumulative blocks indexed

    # -- introspection ------------------------------------------------------------
    @property
    def block_size(self) -> int:
        return self._bs

    @property
    def num_blocks(self) -> int:
        """Blocks currently indexed (each holds one cache reference)."""
        with self._lock:
            return len(self._entries)

    def num_reclaimable(self) -> int:
        """Indexed blocks whose only reference is the cache's own."""
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if self._alloc.refcount(e.block) == 1)

    def stats(self) -> dict:
        with self._lock:
            return {"blocks": len(self._entries),
                    "capacity": self._cap,
                    "insertions": self.insertions,
                    "evictions": self.evictions}

    # -- the chain walk -----------------------------------------------------------
    def _walk(self, tokens) -> List[bytes]:
        """Chain keys of every full block of ``tokens``, in prefix order."""
        toks = _np.asarray(tokens)
        out: List[bytes] = []
        key = ROOT_KEY
        for i in range(len(toks) // self._bs):
            key = chain_hash(key, toks[i * self._bs:(i + 1) * self._bs])
            out.append(key)
        return out

    def peek(self, tokens) -> int:
        """Tokens the index would serve for this prompt (longest cached
        full-block prefix), without taking references or touching LRU."""
        keys = self._walk(tokens)
        n = 0
        with self._lock:
            for k in keys:
                if k not in self._entries:
                    break
                n += 1
        return n * self._bs

    def acquire(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix match for ``tokens``: the shared physical
        blocks (one reference taken on each) and the token count they
        cover.  Touches the matched chain's LRU recency."""
        keys = self._walk(tokens)
        blocks: List[int] = []
        with self._lock:
            self._tick += 1
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    break
                e.tick = self._tick
                blocks.append(e.block)
            if blocks:
                self._alloc.incref(blocks)
        return blocks, len(blocks) * self._bs

    def insert(self, tokens, blocks: List[int]) -> int:
        """Index every full block of ``tokens`` not yet present, taking
        one cache reference per newly indexed block.  ``blocks[i]`` must
        hold the K/V of tokens ``[i*bs, (i+1)*bs)``.  A chain key that
        already exists keeps its block (equal chained keys mean equal
        token prefixes).  Returns the number of blocks newly indexed;
        stops early if the capacity cap cannot be honored by evicting
        elsewhere."""
        toks = _np.asarray(tokens)
        n_full = min(len(toks) // self._bs, len(blocks))
        if n_full <= 0:
            return 0
        added = 0
        with self._lock:
            self._tick += 1
            key = ROOT_KEY
            parent: Optional[_Entry] = None
            protect = set()
            for i in range(n_full):
                key = chain_hash(key, toks[i * self._bs:(i + 1) * self._bs])
                e = self._entries.get(key)
                if e is None:
                    if self._cap and len(self._entries) >= self._cap:
                        # make room, never by sawing off our own chain
                        if not self._evict_one_locked(protect):
                            break
                    b = int(blocks[i])
                    if self._alloc.refcount(b) < 1:
                        break  # caller raced a release; stop cleanly
                    self._alloc.incref([b])
                    e = _Entry(key, b, parent, self._tick)
                    self._entries[key] = e
                    if parent is not None:
                        parent.children += 1
                    self.insertions += 1
                    added += 1
                else:
                    e.tick = self._tick
                protect.add(key)
                parent = e
        return added

    # -- eviction -----------------------------------------------------------------
    def _evict_one_locked(self, protect=()) -> bool:
        """Drop the least-recently-used cache-only leaf (refcount 1, no
        indexed children): its block returns to the free list.  Returns
        False when nothing qualifies."""
        victim: Optional[_Entry] = None
        for e in self._entries.values():
            if e.children or e.key in protect:
                continue
            if self._alloc.refcount(e.block) != 1:
                continue  # a request still reads it: evicting frees nothing
            if victim is None or e.tick < victim.tick:
                victim = e
        if victim is None:
            return False
        del self._entries[victim.key]
        if victim.parent is not None:
            victim.parent.children -= 1
        self._alloc.decref([victim.block])
        self.evictions += 1
        return True

    def evict_blocks(self, n: int) -> int:
        """Evict up to ``n`` cache-only leaves LRU-first.  Returns the
        number of blocks actually freed."""
        freed = 0
        with self._lock:
            while freed < int(n) and self._evict_one_locked():
                freed += 1
        return freed

    def drop_all(self) -> int:
        """Release every cache reference and clear the index (service
        shutdown).  Blocks still shared with live requests just lose the
        cache's reference."""
        with self._lock:
            n = len(self._entries)
            for e in self._entries.values():
                self._alloc.decref([e.block])
            self._entries.clear()
        return n
