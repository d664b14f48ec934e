"""Gluon's recurrent cells: one step a call; ``unroll`` loops the steps.

PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/rnn_cell.py).  The cells' ``hybrid_forward`` is
the reference's arithmetic (i2h + h2h ``FullyConnected`` pairs, gates
LSTM i, f, g, o and GRU r, z, n).  ``unroll`` splits the sequence with
the ``split`` op and stacks the outputs, so it runs on NDArrays (the
imperative path) and on tensors (inside a parent block's forward) alike.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...context import context_of
from ..block import HybridBlock
from ..nn import basic_layers

def _begin(cell, batch_size, x):
    """``cell``'s zero begin states beside ``x``: NDArrays on its context,
    or tensors on its device."""
    if isinstance(x, nd.NDArray):
        return cell.begin_state(batch_size, ctx=x.context)
    return [s._data for s in
            cell.begin_state(batch_size, ctx=context_of(x.device))]


def _like(values, x):
    """``values`` (lengths) as the kind of ``x``: an NDArray on its
    context, or a tensor on its device."""
    if isinstance(x, nd.NDArray):
        return values if isinstance(values, nd.NDArray) else \
            nd.array(values, ctx=x.context)
    if isinstance(values, nd.NDArray):
        values = values._data
    return torch.as_tensor(values, dtype=torch.float32, device=x.device)


__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(nd.zeros(info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch_axis = layout.find("N")
        batch_size = inputs.shape[batch_axis]
        if begin_state is None:
            begin_state = _begin(self, batch_size, inputs)
        states = begin_state
        outputs = []
        all_states = [] if valid_length is not None else None
        steps = nd.split(inputs, num_outputs=length, axis=axis,
                         squeeze_axis=1) if length > 1 else \
            [nd.squeeze(inputs, axis=axis)]
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
            if all_states is not None:
                all_states.append(states)
        if valid_length is not None:
            # padded steps' outputs masked to zero, and each sequence's
            # states taken at t = valid_length - 1 (not t = length - 1)
            vl = _like(valid_length, inputs)
            stacked = nd.stack(*outputs, axis=0)          # (T, N, ...)
            masked = nd.SequenceMask(stacked, vl, use_sequence_length=True)
            outputs = [masked[i] for i in range(length)]
            n_state = len(all_states[0])
            states = [nd.SequenceLast(
                nd.stack(*[st[j] for st in all_states], axis=0), vl,
                use_sequence_length=True) for j in range(n_state)]
        if merge_outputs is None or merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class RNNCell(RecurrentCell):
    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight",
                                              shape=(hidden_size, input_size),
                                              init=i2h_weight_initializer,
                                              allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight",
                                              shape=(hidden_size, hidden_size),
                                              init=h2h_weight_initializer)
            self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                            init=_init(i2h_bias_initializer))
            self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                            init=_init(h2h_bias_initializer))

    def _param_shape(self, param, args):
        return (self._hidden_size, args[0].shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


def _init(spec):
    if spec is None or not isinstance(spec, str):
        return spec
    from ... import initializer as init_mod

    return init_mod.create(spec)


class LSTMCell(RecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight",
                                              shape=(4 * hidden_size, input_size),
                                              init=i2h_weight_initializer,
                                              allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight",
                                              shape=(4 * hidden_size, hidden_size),
                                              init=h2h_weight_initializer)
            self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                            init=_init(i2h_bias_initializer))
            self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                            init=_init(h2h_bias_initializer))

    def _param_shape(self, param, args):
        return (4 * self._hidden_size, args[0].shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h, prev_c = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * prev_c + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight",
                                              shape=(3 * hidden_size, input_size),
                                              init=i2h_weight_initializer,
                                              allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight",
                                              shape=(3 * hidden_size, hidden_size),
                                              init=h2h_weight_initializer)
            self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                            init=_init(i2h_bias_initializer))
            self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                            init=_init(h2h_bias_initializer))

    def _param_shape(self, param, args):
        return (3 * self._hidden_size, args[0].shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0] if isinstance(states, (list, tuple)) else states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum([c.state_info(batch_size) for c in self._children.values()], [])

    def begin_state(self, batch_size=0, **kwargs):
        return sum([c.begin_state(batch_size, **kwargs)
                    for c in self._children.values()], [])

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


class DropoutCell(RecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(RecurrentCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)

    def reset(self):
        super().reset()
        # reset() runs from the base __init__ before base_cell is assigned
        if getattr(self, "base_cell", None) is not None:
            self.base_cell.reset()
        self._prev_output = None  # a stale output must not leak across seqs

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        from ... import autograd

        if autograd.is_training():
            po, ps = self._zoneout_outputs, self._zoneout_states
            prev_output = self._prev_output if self._prev_output is not None \
                else F.zeros_like(next_output)
            if po:
                mask = F.Dropout(F.ones_like(next_output), p=po)
                next_output = F.where(mask, next_output, prev_output)
            if ps:
                next_states = [F.where(F.Dropout(F.ones_like(ns), p=ps), ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = next_output
        return next_output, next_states


class ResidualCell(RecurrentCell):
    def __init__(self, base_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + self.r_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.l_cell.begin_state(batch_size, **kwargs) + \
            self.r_cell.begin_state(batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch_axis = layout.find("N")
        batch_size = inputs.shape[batch_axis]
        if begin_state is None:
            begin_state = _begin(self, batch_size, inputs)
        n_l = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, inputs, begin_state[:n_l],
                                             layout, True, valid_length)
        rev = nd.flip(inputs, axis=axis)
        r_out, r_states = self.r_cell.unroll(length, rev, begin_state[n_l:],
                                             layout, True, valid_length)
        r_out = nd.flip(r_out, axis=axis)
        outputs = nd.concat(l_out, r_out, dim=2)
        return outputs, l_states + r_states
