"""BucketingModule: training over variable-length sequences.

PyTorch counterpart of ``mxnet_tpu/module/bucketing_module.py``
(reference: python/mxnet/module/bucketing_module.py).  ``sym_gen(key)``
gives each bucket's symbol; each bucket binds its own ``Module`` (its own
executor at the bucket's shapes) the first time a batch of that
``bucket_key`` arrives.  ``switch_bucket`` copies the current module's
parameters into the bucket it switches to (a new bucket initializes from
them), so every bucket trains one set of weights, and every bucket's
module borrows one optimizer and ``Updater`` (its state slots follow the
parameter order, the same in every bucket).

``fit`` is ``BaseModule.fit``: a ``BucketingModule`` takes no fused step
(``_try_fused_step`` is the base class's), so each batch is
``forward_backward`` then ``update`` on the bucket's module, the
reference's route.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._grad_req = "write"
        self._monitor = None

    def _gen_symbol(self, key):
        sym, data_names, label_names = self._sym_gen(key)
        return sym, data_names, label_names

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._gen_symbol(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._gen_symbol(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.params_initialized
        self._params_dirty = False
        return self._curr_module.get_params()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer=initializer, arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req
        sym, data_names, label_names = self._gen_symbol(self._default_bucket_key)
        module = Module(sym, data_names, label_names, logger=self.logger,
                        context=self._context,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        assert self.binded
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._gen_symbol(bucket_key)
            module = Module(sym, data_names, label_names, logger=self.logger,
                            context=self._context,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            compression_params=self._compression_params)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad, force_rebind=False,
                        grad_req=self._grad_req)
            # the current module holds the trained weights: the default
            # bucket's are stale once another bucket has trained
            arg_params, aux_params = self._curr_module.get_params()
            module.init_params(arg_params=arg_params, aux_params=aux_params,
                               allow_missing=False, force_init=True)
            if self.optimizer_initialized:
                module.borrow_optimizer(self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        else:
            # the bucket sees the weights the current bucket trained
            arg_params, aux_params = self._curr_module.get_params()
            self._buckets[bucket_key]._exec.copy_params_from(
                arg_params, aux_params, allow_extra_params=True)
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        if self._monitor is not None:
            self._curr_module.install_monitor(self._monitor)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._curr_bucket_key
        data_shapes = [(d.name, tuple(d.shape)) for d in data_batch.provide_data] \
            if data_batch.provide_data else \
            [(n, tuple(a.shape)) for n, a in
             zip(self._curr_module.data_names, data_batch.data)]
        label_shapes = None
        if data_batch.provide_label:
            label_shapes = [(d.name, tuple(d.shape)) for d in data_batch.provide_label]
        elif data_batch.label:
            label_shapes = [(n, tuple(a.shape)) for n, a in
                            zip(self._curr_module.label_names, data_batch.label)]
        if bucket_key is not None:
            self.switch_bucket(bucket_key, data_shapes, label_shapes)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.prepare(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def get_states(self, merge_multi_context=True):
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._curr_module.set_states(states, value)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._curr_module.save_checkpoint(prefix, epoch, save_optimizer_states)
