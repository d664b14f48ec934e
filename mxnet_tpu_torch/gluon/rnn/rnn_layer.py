"""Gluon's fused recurrent layers: ``RNN``, ``LSTM``, ``GRU``.

PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py), over the fused ``RNN`` op
(``ops/rnn.py``).  Layout ``TNC`` or ``NTC``; the input size is deferred
to the first call unless ``input_size`` is given.  The flat parameter
blob takes its own ``init="uniform"``, never a global initializer
(Xavier has no fan for a 1-D blob).  Called without states the layer
starts from zeros and returns the output alone; with states it returns
``(output, new states)``.  Inter-layer dropout draws its key from the
stream (one draw a call, as every random op's wrapper does).
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ops.rnn import rnn_param_size
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        with self.name_scope():
            shape = (rnn_param_size(mode, num_layers, input_size, hidden_size,
                                    bidirectional),) if input_size else (0,)
            self.parameters = self.params.get("parameters", shape=shape,
                                              init="uniform",
                                              allow_deferred_init=True)

    def _param_shape(self, param, args):
        return (rnn_param_size(self._mode, self._num_layers,
                               args[0].shape[-1], self._hidden_size,
                               self._dir == 2),)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (on ``ctx=`` or the current
        context)."""
        return [nd.zeros(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, inputs, states=None, parameters=None):
        if self._layout == "NTC":
            inputs = F.transpose(inputs, axes=(1, 0, 2))
        explicit_states = states is not None
        if states is None:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        if not isinstance(states, (list, tuple)):
            states = [states]
        out = F.RNN(inputs, parameters, *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=explicit_states)
        if explicit_states:
            outputs, out_states = out[0], list(out[1:])
        else:
            outputs, out_states = out, None
        if self._layout == "NTC":
            outputs = F.transpose(outputs, axes=(1, 0, 2))
        return (outputs, out_states) if explicit_states else outputs

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._hidden_size}, "
                f"layers={self._num_layers}, bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_" + ("relu" if activation == "relu" else "tanh"),
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
