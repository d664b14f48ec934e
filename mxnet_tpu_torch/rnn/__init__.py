"""The legacy symbolic RNN API, ``mx.rnn``: cells, ``BucketSentenceIter``
and the RNN checkpoint helpers (PyTorch counterpart of
``mxnet_tpu/rnn/``; reference: python/mxnet/rnn/)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from . import rnn_cell, rnn, io  # noqa: F401

__all__ = rnn_cell.__all__ + rnn.__all__ + io.__all__
