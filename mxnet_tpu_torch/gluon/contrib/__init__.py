"""``gluon.contrib`` (PyTorch counterpart of ``mxnet_tpu/gluon/contrib/``):
the experimental blocks of ``nn``.  The convolutional and
variational-dropout RNN cells (``rnn``) and ``data`` are ROADMAP.md
Queue 1, items 7 and 6h."""
from . import nn  # noqa: F401

__all__ = ["nn"]
