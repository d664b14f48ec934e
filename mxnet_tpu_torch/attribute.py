"""Attribute scoping: ``AttrScope``.

PyTorch-port copy of ``mxnet_tpu/attribute.py`` (reference:
python/mxnet/attribute.py).  Attributes set here land in each symbol
node's ``attr_dict`` and so in the graph JSON.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _tls = threading.local()

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, str):
                # reference attribute.py: 'Attributes need to be string' —
                # silently stringifying dicts/ints attaches garbage to
                # every symbol in scope
                raise ValueError(
                    f"AttrScope value for {k!r} must be a string, "
                    f"got {type(v).__name__}")
        self._attr = dict(kwargs)

    def get(self, attr):
        out = dict(self._attr)
        if attr:
            for k, v in attr.items():
                if not isinstance(v, str):
                    # same contract as __init__: per-call attr= dicts must
                    # not smuggle non-string values into attr_dict/tojson
                    raise ValueError(
                        f"attr value for {k!r} must be a string, "
                        f"got {type(v).__name__}")
                out[k] = v
        return out

    def __enter__(self):
        stack = AttrScope._stack()
        merged = dict(stack[-1]._attr)
        merged.update(self._attr)
        self._attr = merged
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = AttrScope._stack()
        if len(stack) <= 1:
            raise RuntimeError(
                "AttrScope.__exit__ without a matching __enter__")
        stack.pop()

    @staticmethod
    def _stack():
        if not hasattr(AttrScope._tls, "stack"):
            AttrScope._tls.stack = [AttrScope()]
        return AttrScope._tls.stack


def current() -> AttrScope:
    return AttrScope._stack()[-1]
