"""Automatic op naming: ``NameManager`` and ``Prefix``.

PyTorch-port copy of ``mxnet_tpu/name.py`` (reference:
python/mxnet/name.py).  A symbol's graph JSON holds the names made here
(``fullyconnected0``, ...), so the counters follow the reference's
exactly: one counter per lower-cased hint, per manager.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    _tls = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        stack = NameManager._stack()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = NameManager._stack()
        if len(stack) <= 1:
            raise RuntimeError(
                "NameManager.__exit__ without a matching __enter__")
        stack.pop()

    @staticmethod
    def _stack():
        if not hasattr(NameManager._tls, "stack"):
            NameManager._tls.stack = [NameManager()]
        return NameManager._tls.stack


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        # reference name.py Prefix: the prefix applies to EXPLICIT names
        # too — dropping it for named layers collides parameter names
        # across blocks and changes checkpoint keys
        return self._prefix + (name if name else super().get(None, hint))


def current() -> NameManager:
    return NameManager._stack()[-1]
