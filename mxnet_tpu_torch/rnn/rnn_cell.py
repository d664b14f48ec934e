"""Legacy symbolic RNN cells (``mx.rnn``).

PyTorch counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference:
python/mxnet/rnn/rnn_cell.py).  Cells compose ``Symbol`` graphs step by
step; ``unroll`` builds the full-length graph, which the executor runs
node by node, and ``FusedRNNCell`` lowers to the single ``RNN`` op
(``ops/rnn.py``).  The graphs are the reference's node for node, so
``tojson`` writes its bytes.

Deferred begin state: the reference leaves the begin states' batch dim
unknown (shape (0, H)); here, as in the JAX package, the ``_state_zeros``
op takes the batch dim from the step input inside the graph.
"""
from __future__ import annotations

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RNNParams:
    """Container holding shared variables for cells (reference: RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class _DeferredZeros:
    """Placeholder begin-state: materializes as `_state_zeros(step0)` once the
    first step input is known (batch dim inferred inside the graph)."""

    def __init__(self, num_hidden):
        self.num_hidden = num_hidden

    def materialize(self, data_sym):
        return getattr(symbol, "_state_zeros")(data_sym,
                                               num_hidden=self.num_hidden)


def _materialize(states, data_sym):
    return [s.materialize(data_sym) if isinstance(s, _DeferredZeros) else s
            for s in states]


class BaseRNNCell:
    """Abstract symbolic cell (reference: BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states. Default: deferred zeros whose batch dim is
        inferred from the step input at unroll/call time. Pass an explicit
        `func` (e.g. `sym.zeros`) plus `batch_size=` for concrete shapes."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called directly"
        batch_size = kwargs.pop("batch_size", 0)
        shape_override = kwargs.pop("shape", None)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is None:
                states.append(_DeferredZeros(info["shape"][-1]))
            else:
                shape = shape_override or info["shape"]
                # 0 dims are the reference's unknown-batch markers
                shape = tuple(batch_size if d == 0 else d for d in shape)
                states.append(func(shape=shape, **kwargs))
        return states

    def unpack_weights(self, args):
        """Split fused per-cell weight blobs into per-gate arrays
        (reference: BaseRNNCell.unpack_weights)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                name = f"{self._prefix}{group}_{t}"
                if name not in args:
                    continue
                blob = args.pop(name)
                for j, gate in enumerate(self._gate_names):
                    args[f"{self._prefix}{group}{gate}_{t}"] = \
                        blob[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        import numpy as _np

        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                parts = []
                for gate in self._gate_names:
                    name = f"{self._prefix}{group}{gate}_{t}"
                    if name in args:
                        parts.append(args.pop(name))
                if parts:
                    arrs = [p.asnumpy() if hasattr(p, "asnumpy") else _np.asarray(p)
                            for p in parts]
                    from ..ndarray import array as nd_array

                    args[f"{self._prefix}{group}_{t}"] = nd_array(
                        _np.concatenate(arrs, axis=0))
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None, input_prefix=""):
        """Unroll `length` steps (reference: BaseRNNCell.unroll).

        inputs: one Symbol of shape layout NTC/TNC, a list of step symbols,
        or None (auto-creates `{input_prefix}t{i}_data` variables).
        Returns (outputs, states): outputs merged along the time axis when
        merge_outputs is True, else a list.
        """
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable(f"{input_prefix}t{i}_data")
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            if len(inputs.list_outputs()) != 1:
                raise MXNetError("unroll: inputs must be a single-output symbol")
            inputs = list(symbol.SliceChannel(inputs, num_outputs=length,
                                              axis=axis, squeeze_axis=1))
        else:
            inputs = list(inputs)
        if len(inputs) != length:
            raise MXNetError(f"unroll: got {len(inputs)} step inputs, want {length}")

        if begin_state is None:
            begin_state = self.begin_state()
        states = _materialize(begin_state, inputs[0])

        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell h' = act(W_i x + W_h h + b) (reference: RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        states = _materialize(states, inputs)
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB, num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: LSTMCell; gate order i, f, g, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        states = _materialize(states, inputs)
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        sliced = symbol.SliceChannel(gates, num_outputs=4,
                                     name=f"{name}slice")
        in_gate = symbol.Activation(sliced[0], act_type="sigmoid")
        forget_gate = symbol.Activation(sliced[1] + self._forget_bias,
                                        act_type="sigmoid")
        in_transform = symbol.Activation(sliced[2], act_type="tanh")
        out_gate = symbol.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference: GRUCell; gate order r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        states = _materialize(states, inputs)
        name = f"{self._prefix}t{self._counter}_"
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}h2h")
        i2h_r, i2h_z, i2h_n = list(symbol.SliceChannel(
            i2h, num_outputs=3, name=f"{name}i2h_slice"))
        h2h_r, h2h_z, h2h_n = list(symbol.SliceChannel(
            h2h, num_outputs=3, name=f"{name}h2h_slice"))
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_n + reset_gate * h2h_n,
                                       act_type="tanh")
        ones = symbol.ones_like(update_gate)
        next_h = (ones - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN lowering to the single ``RNN`` op
    (``ops/rnn.py``; reference: FusedRNNCell, cuDNN's RNN there)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameters = self.params.get("parameters")

    @property
    def state_info(self):
        dirs = 2 if self._bidirectional else 1
        b = (self._num_layers * dirs, 0, self._num_hidden)
        if self._mode == "lstm":
            return [{"shape": b, "__layout__": "LNC"},
                    {"shape": b, "__layout__": "LNC"}]
        return [{"shape": b, "__layout__": "LNC"}]

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def begin_state(self, func=None, **kwargs):
        # fused states are (L*dirs, N, H); deferred zeros need the RNN op's
        # own zero-state default, so signal with None markers
        if func is None:
            return [None] * len(self.state_info)
        return super().begin_state(func=func, **kwargs)

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None, input_prefix=""):
        self.reset()
        # `layout` names the CALLER's layout for tensor inputs and the output
        # format either way; a list of per-step inputs is assembled time-major
        # internally without changing the requested output layout
        inputs_are_tnc = False
        if inputs is None:
            inputs = symbol.Variable(f"{input_prefix}data")
        elif not isinstance(inputs, symbol.Symbol):
            inputs = [symbol.expand_dims(s, axis=0) for s in inputs]
            inputs = symbol.Concat(*inputs, dim=0)  # already TNC
            inputs_are_tnc = True
        if layout == "NTC" and not inputs_are_tnc:
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        states = begin_state or [None] * len(self.state_info)

        kwargs = {}
        if states[0] is not None:
            kwargs["state"] = states[0]
        if self._mode == "lstm" and len(states) > 1 and states[1] is not None:
            kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameters,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         name=f"{self._prefix}rnn", **kwargs)
        if self._get_next_state:
            outputs, states = rnn[0], list(rnn)[1:]
        else:
            outputs, states = rnn, []
        if layout == "NTC":
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, num_outputs=length,
                axis=layout.find("T"), squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Equivalent stack of unfused cells (reference: FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu",
                                          prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh",
                                          prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order per step (reference: SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell._params._params.update(self._params._params)
            self._params._params = cell._params._params

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        return sum([c.begin_state(func=func, **kwargs)
                    for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cell over the sequence (reference: BidirectionalCell).
    Only usable through unroll (needs the whole sequence)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, func=None, **kwargs):
        return sum([c.begin_state(func=func, **kwargs)
                    for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None, input_prefix=""):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable(f"{input_prefix}t{i}_data")
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            inputs = list(symbol.SliceChannel(inputs, num_outputs=length,
                                              axis=axis, squeeze_axis=1))
        else:
            inputs = list(inputs)
        l_cell, r_cell = self._cells
        begin = begin_state or self.begin_state()
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)), begin_state=begin[n_l:],
            layout=layout, merge_outputs=False)
        outputs = [symbol.Concat(l, r, dim=1,
                                 name=f"{self._output_prefix}t{i}")
                   for i, (l, r) in enumerate(zip(l_outputs,
                                                  reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix="", params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on the step output (reference: DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(  # noqa: E731
            data=symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = (symbol.where(mask(self.zoneout_outputs, next_output),
                               next_output, prev_output)
                  if self.zoneout_outputs > 0.0 else next_output)
        states = ([symbol.where(mask(self.zoneout_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states,
                                           _materialize(states, inputs))]
                  if self.zoneout_states > 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output (reference: ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name=f"{output.name}_plus_residual")
        return output, states

    def unroll(self, length, inputs=None, begin_state=None, layout="NTC",
               merge_outputs=None, input_prefix=""):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, input_prefix=input_prefix)
        self.base_cell._modified = True
        if merge_outputs:
            if isinstance(inputs, list):
                axis = layout.find("T")
                inputs = [symbol.expand_dims(s, axis=axis) for s in inputs]
                inputs = symbol.Concat(*inputs, dim=axis)
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            if isinstance(inputs, symbol.Symbol):
                axis = layout.find("T")
                inputs = list(symbol.SliceChannel(
                    inputs, num_outputs=length, axis=axis, squeeze_axis=1))
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        return outputs, states
