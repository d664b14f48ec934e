"""SequentialModule: a chain of modules, each one's outputs the next
one's data (PyTorch counterpart of ``mxnet_tpu/module/sequential_module.py``;
reference: python/mxnet/module/sequential_module.py).  ``add(module,
take_labels=, auto_wiring=)``; the backward passes each module's input
gradients to the one before it."""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=allow_missing,
                               force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert len(self._modules) > 0
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas, self._modules)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta_take_labels:
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = for_training and (inputs_need_grad or i_layer > 0)
            if meta.get(self.META_AUTO_WIRING, False) and i_layer > 0:
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [(new_name, shape) for new_name, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes, label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_ever_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            out = module.get_outputs()
            batch = DataBatch(data=out, label=data_batch.label, pad=data_batch.pad,
                              index=data_batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i_layer]
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
