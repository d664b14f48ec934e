"""The global random stream.

PyTorch counterpart of ``mxnet_tpu/random.py``: one threefry key per
thread, split once per consuming op, so every random op is a pure function
of an explicit key while the user-facing API stays stateful, and the bits
are the reference's own.  The key is a host ``numpy.uint32[2]``;
``split(key)[i]`` is ``threefry2x32(key, (0, i))`` (JAX's partitionable
threefry layout) and ``PRNGKey(s)`` is ``(0, s)``.

Thread rules (the reference's): the main thread's stream is the seeded
base key itself; a worker thread's is ``fold_in(base, n)`` with ``n`` its
first-touch ordinal.  :func:`seed` bumps a generation counter, so every
thread re-derives its key at its next draw.

Inside a hybridized block's program the stream is a :class:`LazyKey`
(:func:`swap_key`): splits only extend its path, and a random op that
consumes one asks the program for the key's value (host-computed from the
call's key, then a device tensor), so a captured CUDA graph reads its keys
from a buffer the call fills and never computes a split per block.
"""
from __future__ import annotations

import itertools
import sys
import threading

import numpy as np
import torch

from .ops.sampling import threefry2x32

__all__ = ["seed", "next_key", "fold_in", "get_state", "set_state",
           "swap_key", "split", "key_tensor", "LazyKey"]

_M32 = 0xFFFFFFFF
_DEFAULT_SEED = 0

_state = threading.local()
_base = {"key": None, "gen": 0}
_base_lock = threading.Lock()
_thread_seq = itertools.count(1)


def _key(words) -> np.ndarray:
    return np.asarray(words, dtype=np.uint32)


def prng_key(s: int) -> np.ndarray:
    """``jax.random.PRNGKey(s)`` for a seed below 2**32: ``(0, s)``."""
    return _key((0, int(s) & _M32))


def split(key, i: int) -> np.ndarray:
    """``jax.random.split(key)[i]`` (``threefry2x32`` on Python ints)."""
    return _key(threefry2x32(int(key[0]), int(key[1]), 0, int(i)))


def fold(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    return _key(threefry2x32(int(key[0]), int(key[1]), 0,
                             int(data) & _M32))


class LazyKey:
    """A key inside a program: a path of splits from the program's root
    key, evaluated only where a random op consumes it."""

    __slots__ = ("program", "path")

    def __init__(self, program, path=()):
        self.program = program
        self.path = tuple(path)

    def child(self, i: int) -> "LazyKey":
        return LazyKey(self.program, self.path + (("s", int(i)),))

    def folded(self, data: int) -> "LazyKey":
        return LazyKey(self.program, self.path + (("f", int(data)),))

    def value(self, root) -> np.ndarray:
        key = _key(root)
        for kind, v in self.path:
            key = split(key, v) if kind == "s" else fold(key, v)
        return key


def _base_key():
    with _base_lock:
        if _base["key"] is None:
            _base["key"] = prng_key(_DEFAULT_SEED)
        return _base["key"], _base["gen"]


def _thread_index() -> int:
    if threading.current_thread() is threading.main_thread():
        return 0
    if not hasattr(_state, "seq"):
        _state.seq = next(_thread_seq)
    return _state.seq


def _get_key():
    base, gen = _base_key()
    if not hasattr(_state, "key") or getattr(_state, "gen", None) != gen:
        idx = _thread_index()
        _state.key = base if idx == 0 else fold(base, idx)
        _state.gen = gen
    return _state.key


def seed(seed_state: int, ctx=None) -> None:
    """Seed the stream (reference: ``mx.random.seed``): this thread and
    every other re-derive their keys at their next draw."""
    with _base_lock:
        _base["key"] = prng_key(int(seed_state))
        _base["gen"] += 1
    if hasattr(_state, "key"):
        del _state.key


def next_key():
    """Split one subkey off the stream (a :class:`LazyKey` inside a
    program)."""
    key = _get_key()
    if isinstance(key, LazyKey):
        _state.key, sub = key.child(0), key.child(1)
    else:
        _state.key, sub = split(key, 0), split(key, 1)
    return sub


def fold_in(data: int):
    key = _get_key()
    if isinstance(key, LazyKey):
        return key.folded(data)
    return fold(key, data)


def get_state():
    """This thread's key as a host ``uint32[2]`` (``None`` inside a
    program, as the reference returns for a traced key)."""
    key = _get_key()
    if isinstance(key, LazyKey):
        return None
    return np.array(key, dtype=np.uint32)


def set_state(data) -> None:
    """Install a key from :func:`get_state` as this thread's stream."""
    _state.key = _key(np.asarray(data, dtype=np.uint32).reshape(2))
    _state.gen = _base_key()[1]


def swap_key(new_key):
    """Install ``new_key`` as this thread's stream; returns the old key."""
    old = _get_key()
    _state.key = new_key
    return old


def key_tensor(key, device) -> torch.Tensor:
    """A key (host ``uint32[2]`` or :class:`LazyKey`) as the int64 tensor
    of its two words on ``device``, the form the random ops take."""
    if isinstance(key, LazyKey):
        return key.program.key_tensor(key, torch.device(device))
    words = torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64)
    return words.to(device)


def _install_samplers():
    """``mx.random.uniform`` etc. are ``mx.nd.random``'s (reference:
    ``_install_samplers``)."""
    from .ndarray import random as _ndr

    mod = sys.modules[__name__]
    for name in _ndr.__all__:
        if not hasattr(mod, name):
            setattr(mod, name, getattr(_ndr, name))
            __all__.append(name)
