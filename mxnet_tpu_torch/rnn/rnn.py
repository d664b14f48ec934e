"""RNN checkpoint helpers (PyTorch counterpart of ``mxnet_tpu/rnn/rnn.py``;
reference: python/mxnet/rnn/rnn.py).

A fused cell keeps its weights as one blob; these helpers write them
unpacked into per-gate arrays and pack them again on load, so checkpoints
move between fused and unfused cells.  The files are
``model.save_checkpoint``'s, byte for byte the reference's.
"""
from __future__ import annotations

from .. import model as _model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells_of(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``save_checkpoint`` with the cells' weights unpacked per gate."""
    for cell in _cells_of(cells):
        arg_params = cell.unpack_weights(arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``load_checkpoint`` with the per-gate arrays packed into the cells'
    weights."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    for cell in _cells_of(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback writing unpacked checkpoints every ``period``
    epochs (cf. ``callback.do_checkpoint``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
