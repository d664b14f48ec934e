"""Legacy multi-device executor manager (FeedForward-era scripts).

PyTorch counterpart of ``mxnet_tpu/executor_manager.py`` (reference:
python/mxnet/executor_manager.py: ``_split_input_slice``,
``DataParallelExecutorManager``).  The port runs one process per device:
with several contexts the manager makes a ``dp`` mesh of that many ranks
over the world (``parallel.mesh.dp_mesh``), binds its one executor on this
rank's device and attaches the mesh (``Executor.set_spmd``).  Each rank
loads the whole batch; ``forward``/``backward`` give the global outputs
and gradients on every rank (the executor's plain route on a mesh), and
parameters stay whole and equal on every rank.  A mesh the world cannot
hold (a world of one with two contexts) is logged and the manager runs on
its first context.  ``_split_input_slice`` keeps the reference's per-device
slices for callers that slice batches themselves.
"""
from __future__ import annotations

from typing import List

from .base import MXNetError
from .context import context_of
from .ndarray import array as nd_array

__all__ = ["_split_input_slice", "_load_data", "_load_label",
           "DataParallelExecutorManager"]


def _split_input_slice(batch_size: int, work_load_list: List[float]):
    """Slice a batch across devices in proportion to their work load
    (reference: executor_manager.py ``_split_input_slice``)."""
    total = sum(work_load_list)
    if total <= 0:
        raise MXNetError("invalid work_load_list")
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        if end > batch_size:
            raise MXNetError("too many slices — batch size too small")
        slices.append(slice(start, end))
        start = end
    return slices


def _load_general(data, targets, slices=None):
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, list):
            for (sl, d_dst) in d_targets:
                d_dst[:] = nd_array(d_src.asnumpy()[sl],
                                    ctx=d_dst.context)
        else:
            d_targets[:] = d_src


def _load_data(batch, targets, slices=None):
    _load_general(batch.data, targets, slices)


def _load_label(batch, targets, slices=None):
    _load_general(batch.label, targets, slices)


class DataParallelExecutorManager:
    """One executor over a ``dp`` mesh of ``len(ctx)`` ranks (module
    doc); the reference's API for the FeedForward path."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None,
                 sym_gen=None):
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        num_device = len(self.ctx)
        if work_load_list is None:
            work_load_list = [1.0] * num_device
        assert len(work_load_list) == num_device
        self.work_load_list = work_load_list
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.batch_size = train_data.batch_size
        self.slices = _split_input_slice(self.batch_size, work_load_list)

        data_shapes = {d.name: (self.batch_size,) + tuple(d.shape[1:])
                       for d in train_data.provide_data}
        label_shapes = {l.name: (self.batch_size,) + tuple(l.shape[1:])
                        for l in train_data.provide_label}
        self._data_names = list(data_shapes)
        self._label_names = list(label_shapes)
        self._mesh = None
        if num_device > 1:
            from .parallel.mesh import dp_mesh

            try:
                self._mesh = dp_mesh(num_device, device=self.ctx[0])
            except MXNetError as e:
                if logger is not None:
                    logger.warning("SPMD executor unavailable (%s); running "
                                   "on %s only", e, self.ctx[0])
        bind_ctx = self.ctx[0] if self._mesh is None \
            else context_of(self._mesh.device)
        self._exec = symbol.simple_bind(ctx=bind_ctx, grad_req="write",
                                        **data_shapes, **label_shapes)
        if self._mesh is not None:
            try:
                self._exec.set_spmd(
                    self._mesh,
                    batch_args=self._data_names + self._label_names)
            except MXNetError as e:  # an indivisible batch: one device
                if logger is not None:
                    logger.warning("SPMD executor unavailable (%s); running "
                                   "on %s only", e, bind_ctx)
                self._mesh = None

    @property
    def param_arrays(self):
        argmap = dict(zip(self.symbol.list_arguments(), self._exec.arg_arrays))
        return [[argmap[name]] for name in self.param_names]

    @property
    def grad_arrays(self):
        gradmap = dict(zip(self.symbol.list_arguments(),
                           self._exec.grad_arrays))
        return [[gradmap[name]] for name in self.param_names]

    @property
    def aux_arrays(self):
        return [[a] for a in self._exec.aux_arrays]

    def install_monitor(self, monitor):
        monitor.install(self._exec)

    def set_params(self, arg_params, aux_params):
        argmap = dict(zip(self.symbol.list_arguments(), self._exec.arg_arrays))
        for name, arr in arg_params.items():
            if name in argmap:
                argmap[name][:] = arr
        auxmap = dict(zip(self.symbol.list_auxiliary_states(),
                          self._exec.aux_arrays))
        for name, arr in aux_params.items():
            if name in auxmap:
                auxmap[name][:] = arr

    def copy_to(self, arg_params, aux_params):
        argmap = dict(zip(self.symbol.list_arguments(), self._exec.arg_arrays))
        for name in self.param_names:
            arg_params[name] = argmap[name].copy()
        auxmap = dict(zip(self.symbol.list_auxiliary_states(),
                          self._exec.aux_arrays))
        for name, arr in auxmap.items():
            aux_params[name] = arr.copy()

    def load_data_batch(self, data_batch):
        self._batch = data_batch

    def forward(self, is_train=False):
        feed = dict(zip(self._data_names, self._batch.data))
        feed.update(zip(self._label_names, self._batch.label or []))
        self._exec.forward(is_train=is_train, **feed)

    def backward(self):
        self._exec.backward()

    @property
    def curr_execgrp(self):
        return self

    def update_metric(self, metric, labels, pre_sliced=False):
        metric.update(labels, self._exec.outputs)
