"""``gluon.rnn``: the fused recurrent layers and the cells (PyTorch
counterpart of ``mxnet_tpu/gluon/rnn``)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ZoneoutCell,
                       ResidualCell, BidirectionalCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]
