"""Gluon Trainer.

PyTorch counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py — kvstore wiring, step, allreduce_grads,
update): a ``Trainer`` over a ``ParameterDict`` (or list of Parameters)
with an optimizer by name or instance and a kvstore (``"device"`` by
default, as in the reference; ``None`` for none).  ``step(batch_size)``
rescales the gradients by ``1 / batch_size``, reduces them through the
kvstore (push, then pull back into each ``Parameter.grad()``; 2-bit
compressed with ``compression_params``) and applies the optimizer.
Parameters whose deferred shapes resolve after the Trainer was made are
``kvstore.init``-ed on the next call, as the reference re-checks them.
Over a ``dist_*`` store the update runs on the parameter server by
default (``update_on_kvstore``): the optimizer is pickled to it when the
store is made, so its ``rescale_grad`` is the one given then, as in the
reference.

The port pushes and pulls all of a step's gradients as one list and
applies the update through ``Updater(index_list, grad_list,
weight_list)`` (one ``torch._foreach_*`` pass for SGD), where the reference loops over the parameters.
"""
from __future__ import annotations

from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be dict/list of Parameters")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(f"invalid parameter {param}")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, opt_mod.Optimizer):
            self._scale = optimizer.rescale_grad
        else:
            self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_arg = kvstore
        self._update_on_kvstore_arg = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = False
        self._params_to_init = list(self._params)

    def _param_dict(self):
        return {i: param for i, param in enumerate(self._params)}

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) - {"rescale_grad"}:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = self._param_dict()
        else:
            self._optimizer = opt_mod.create(
                optimizer, param_dict=self._param_dict(),
                param_idx2name={i: p.name for i, p in
                                enumerate(self._params)},
                **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    def _init_kvstore(self):
        kv = None
        if isinstance(self._kvstore_arg, kvs_mod.KVStore):
            kv = self._kvstore_arg
        elif isinstance(self._kvstore_arg, str):
            kv = kvs_mod.create(self._kvstore_arg)
        self._kvstore = kv
        update = self._update_on_kvstore_arg
        if update is None:
            update = kv is not None and "dist" in kv.type
        self._update_on_kvstore = bool(update) and kv is not None
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _init_params(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None:
            ready = [p for p in self._params_to_init if p._data is not None]
            if ready:
                self._kvstore.init([self._param2idx[p.name] for p in ready],
                                   [p.data() for p in ready])
        self._params_to_init = [p for p in self._params_to_init
                                if p._data is None]

    def _check_init(self):
        if not self._kv_initialized or self._params_to_init:
            self._init_params()

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _row_sparse_pull(self, parameter, out, row_id, full_idx=False):
        """Pull the rows ``row_id`` of ``parameter`` from the kvstore into
        ``out`` (reference: ``Trainer._row_sparse_pull``)."""
        self._check_init()
        if self._kvstore is not None:
            self._kvstore.row_sparse_pull(self._param2idx[parameter.name],
                                          out=out, row_ids=row_id)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size``, reduce through the kvstore and
        update (reference: trainer.py step)."""
        self._check_init()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        self._check_init()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() is invalid with "
                             "update_on_kvstore")
        self._allreduce_grads()

    def _trainable(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _allreduce_grads(self):
        if self._kvstore is None or self._update_on_kvstore:
            return
        live = [(i, p) for i, p in self._trainable() if p._data is not None]
        if not live:
            return
        keys = [i for i, _ in live]
        grads = [p.list_grad() for _, p in live]
        self._kvstore.push(keys, grads)
        self._kvstore.pull(keys, grads, ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        self._check_init()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        idx, grads, weights = [], [], []
        for i, param in self._trainable():
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(f"parameter {param.name} not "
                                     f"initialized")
                continue
            if self._update_on_kvstore:
                self._kvstore.push(i, param.list_grad())
                self._kvstore.pull(i, param.list_data())
                continue
            idx.append(i)
            grads.append(param.grad())
            weights.append(param.data())
        if idx:
            self._updaters[0](idx, grads, weights)

    def save_states(self, fname):
        """The optimizer's state (and the optimizer itself: such a file
        loads in this package only)."""
        self._check_init()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            with open(fname, "wb") as f:
                f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        self._check_init()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = self._param_dict()
