"""Training-mode and recording flags.

PyTorch counterpart of the scopes of ``mxnet_tpu/autograd.py``
(``record``/``pause``/``train_mode``/``predict_mode``, ``is_training``,
``is_recording``).  Gradients are torch autograd: these scopes set the
per-thread flags that layers read (BatchNorm trains on batch statistics
only under ``is_training()``) and leave torch's grad mode alone, so a
forward inside ``pause()`` still records the torch graph when grad mode
is on.  The tape, ``mark_variables``, ``backward`` and ``Function`` of the
reference come with the NDArray slice.
"""
from __future__ import annotations

import threading

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training"]

_tls = threading.local()


def _st():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
    return _tls


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec = recording
        self._train = training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode: bool = True) -> _Scope:
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(recording=False, training=train_mode)


def train_mode() -> _Scope:
    return _Scope(training=True)


def predict_mode() -> _Scope:
    return _Scope(training=False)


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training

