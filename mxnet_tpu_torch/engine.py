"""Host-side execution engine facade.

PyTorch counterpart of ``mxnet_tpu/engine.py``: the control API of MXNet's
dependency engine, kept so user code carries over.  CUDA streams already
give the asynchronous dispatch the reference's engine provides, so what
remains is:

- ``set_bulk_size`` / ``bulk`` / ``fusion_hint``: the op-bulking knob.
  Inside an explicit ``bulk(k)`` scope :func:`fusion_hint` is ``k``; the
  generation engine's multi-step decode then runs up to ``k`` decode
  iterations per dispatch even with requests waiting.
- NaiveEngine mode (``MXNET_ENGINE_TYPE=NaiveEngine``): the mode flag and
  scope, for code that asks :func:`is_naive`.
- :func:`wait_all`: ``torch.cuda.synchronize`` when a card is present.

The reference's C++ host dependency engine (``push``, ``new_var``,
``wait_for_var``, ``host_engine``) is not ported: those names raise
:class:`~mxnet_tpu_torch.base.MXNetError`.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError, getenv

__all__ = ["set_bulk_size", "bulk_size", "bulk", "fusion_hint", "is_naive",
           "wait_all", "push", "new_var", "wait_for_var", "host_engine",
           "NaiveEngine", "set_engine_type", "current_engine_type"]

_ENGINE_TYPE = getenv("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
# process-wide, as MXEngineSetBulkSize is
_bulk_size = 15
_bulk_lock = threading.Lock()
# open bulk() scopes: the bulk size is a fusion hint only inside one
_bulk_depth = 0


def is_naive() -> bool:
    return _ENGINE_TYPE == "NaiveEngine"


def current_engine_type() -> str:
    """The active engine mode (the environment, :func:`set_engine_type`
    or a live :class:`NaiveEngine` scope)."""
    return _ENGINE_TYPE


def set_engine_type(name: str) -> None:
    global _ENGINE_TYPE
    _ENGINE_TYPE = name


def set_bulk_size(size: int) -> int:
    """Set the bulk size; returns the previous value."""
    global _bulk_size
    with _bulk_lock:
        old = _bulk_size
        _bulk_size = int(size)
    return old


def bulk_size() -> int:
    return _bulk_size


def fusion_hint() -> int:
    """The bulk size inside an explicit :func:`bulk` scope, else 1: the
    number of whole steps a caller asks to run per device dispatch."""
    with _bulk_lock:
        return _bulk_size if _bulk_depth > 0 else 1


class _BulkScope:
    """A reusable bulk scope (it can be stored and re-entered)."""

    def __init__(self, size: int):
        self._size = int(size)
        self._old: list = []

    def __enter__(self):
        global _bulk_depth
        self._old.append(set_bulk_size(self._size))
        with _bulk_lock:
            _bulk_depth += 1
        return self

    def __exit__(self, *exc):
        global _bulk_depth
        with _bulk_lock:
            _bulk_depth -= 1
        set_bulk_size(self._old.pop())


def bulk(size: int) -> _BulkScope:
    """Scope in which :func:`fusion_hint` is ``size``."""
    return _BulkScope(size)


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise MXNetError(
            f"engine.{name}: the C++ host dependency engine is not ported "
            f"(ROADMAP.md Queue 1, item 6)")
    refuse.__name__ = name
    refuse.__doc__ = (f"{name}: not ported (the C++ host dependency "
                      f"engine; ROADMAP.md Queue 1, item 6).")
    return refuse


host_engine = _not_ported("host_engine")
new_var = _not_ported("new_var")
push = _not_ported("push")
wait_for_var = _not_ported("wait_for_var")


def wait_all() -> None:
    """Block until every queued device operation has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class NaiveEngine:
    """Context manager setting the NaiveEngine mode."""

    def __enter__(self):
        global _ENGINE_TYPE
        self._old = _ENGINE_TYPE
        _ENGINE_TYPE = "NaiveEngine"
        return self

    def __exit__(self, *exc):
        global _ENGINE_TYPE
        _ENGINE_TYPE = self._old
