"""Model helpers: checkpoint files, kvstore wiring for ``Module``, and the
legacy ``FeedForward`` API.

PyTorch counterpart of ``mxnet_tpu/model.py`` (reference:
python/mxnet/model.py).  ``save_checkpoint`` writes the reference's
``prefix-symbol.json`` and ``prefix-%04d.params`` byte for byte (the
symbol's ``tojson`` and ``nd.save``), with the same sidecar
``<params>.manifest.json`` (sha256 and key list) that ``load_checkpoint``
checks before it reads; each package reads the other's files.
"""
from __future__ import annotations

import os
import struct as _struct
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .checkpoint.integrity import verify_params_file, write_params_manifest
from .kvstore import KVStore, create as _create_kv

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint", "load_checkpoint",
           "_create_kvstore", "_initialize_kvstore", "_update_params_on_kvstore",
           "_update_params", "_fused_step_allowed"]


def _fused_step_allowed(optimizer, kvstore, update_on_kvstore,
                        num_device: int) -> bool:
    """Whether a Module may route fit through the fused train step
    (``Executor.fused_step``): no update on the store, and a store (if
    any) whose per-parameter round trip is a copy.  With several devices
    the fused step runs over a dp mesh (``Executor.set_spmd``), which also
    needs a collective-capable store (``supports_spmd_fused``: ``device``
    or ``tpu_sync``) and is switched off alone by
    ``TPUMX_FUSED_STEP_SPMD=0``.  ``TPUMX_FUSED_STEP=0`` takes the legacy
    route everywhere, as in the reference."""
    if os.environ.get("TPUMX_FUSED_STEP", "1") == "0":
        return False
    if num_device != 1:
        if os.environ.get("TPUMX_FUSED_STEP_SPMD", "1") == "0":
            return False
        if kvstore is None or not getattr(kvstore, "supports_spmd_fused",
                                          False):
            return False
    if optimizer is None or update_on_kvstore:
        return False
    if kvstore is not None and not kvstore._fused_step_ok():
        return False
    return True


BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device: int, arg_params):
    """Returns (kvstore, update_on_kvstore) — reference model.py
    _create_kvstore."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = _create_kv(kvstore)
            if kvstore == "local":
                max_size = max(p.size for p in arg_params.values()) if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is not None and kv.type == "tpu_sync":
        # a collective boundary, not a parameter server: the update never
        # runs on the store
        update_on_kvstore = False
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init each param on the store, broadcasting rank-0 weights
    (reference model.py _initialize_kvstore)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore, param_names):
    """Push grads / pull updated weights, priority-ordered (reference
    model.py _update_params_on_kvstore)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Reduce grads through the kvstore, then run the local updater per
    device (reference model.py _update_params)."""
    updates = [[] for _ in range(num_device)]
    for i, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        index = i
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updates[k].append((index * num_device + k, g, w))
    for dev_updates in updates:
        if dev_updates:
            i, g, w = zip(*dev_updates)
            updater(list(i), list(g), list(w))


def _load_params_file(params_path: str):
    """(arg_params, aux_params) of a params file, checked against its
    manifest."""
    verify_params_file(params_path)
    try:
        save_dict = nd.load(params_path)
    except MXNetError:
        raise
    except (_struct.error, ValueError, EOFError, OSError, KeyError) as e:
        raise MXNetError(
            f"checkpoint file {params_path!r} is corrupt/truncated and "
            f"cannot be deserialized: {type(e).__name__}: {e}") from e
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        if ":" not in k:
            raise MXNetError(
                f"checkpoint file {params_path!r} holds malformed key "
                f"{k!r} (expected 'arg:<name>' or 'aux:<name>')")
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    verify_params_file(params_path, loaded_keys=list(save_dict))
    return arg_params, aux_params


def _save_params_file(params_path: str, arg_params, aux_params) -> None:
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(params_path, save_dict)
    write_params_manifest(params_path, list(save_dict))


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write prefix-symbol.json + prefix-%04d.params (and the params
    file's manifest) — reference: model.py save_checkpoint.
    ``remove_amp_cast`` (default True, as the reference) strips the AMP
    cast nodes first, so the graph file is the original-precision one."""
    if symbol is not None:
        if remove_amp_cast:
            from .amp import remove_amp_cast as _strip

            symbol = _strip(symbol)
        symbol.save(f"{prefix}-symbol.json")
    _save_params_file(f"{prefix}-{epoch:04d}.params", arg_params, aux_params)


def load_checkpoint(prefix, epoch):
    """Returns (symbol, arg_params, aux_params) — reference: model.py
    load_checkpoint.  The params file is checked against its manifest
    when there is one."""
    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = _load_params_file(f"{prefix}-{epoch:04d}.params")
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy training API (reference: model.py FeedForward): a thin shell
    over :class:`Module` — fit/predict/score plus the prefix-epoch
    checkpoint format."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as _init_mod

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else _init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        # reference convention: remaining kwargs are optimizer params
        # (learning_rate, momentum, wd, ...)
        self._optimizer_params = kwargs
        self._module = None

    # -- internals ---------------------------------------------------------------
    def _as_iter(self, X, y=None, batch_size=None, shuffle=False):
        from .io import DataIter, NDArrayIter, ResizeIter

        it = X if isinstance(X, DataIter) else NDArrayIter(
            X, y, batch_size or self.numpy_batch_size, shuffle=shuffle)
        if self.epoch_size is not None and shuffle:
            # reference semantics: epoch_size bounds batches/epoch (needed
            # for infinite record iterators)
            it = ResizeIter(it, self.epoch_size)
        return it

    def _bind_module(self, data_iter, for_training):
        from .module import Module

        label_names = [d.name for d in (data_iter.provide_label or [])] \
            or None
        mod = Module(self.symbol, label_names=label_names,
                     context=self.ctx)
        mod.bind(data_iter.provide_data,
                 data_iter.provide_label or None,
                 for_training=for_training)
        mod.init_params(initializer=self.initializer,
                        arg_params=self.arg_params,
                        aux_params=self.aux_params,
                        allow_missing=self.arg_params is not None,
                        allow_extra=self.allow_extra_params)
        self._module = mod
        return mod

    # -- API ---------------------------------------------------------------------
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module

        if self.num_epoch is None:
            # reference requires it (Module.fit asserts); a silent default
            # combined with begin_epoch from load() could train 0 epochs
            raise ValueError("FeedForward: num_epoch must be set to fit")
        train = self._as_iter(X, y, shuffle=True)
        label_names = [d.name for d in (train.provide_label or [])] or None
        mod = Module(self.symbol, label_names=label_names, context=self.ctx,
                     logger=logger) if logger is not None else \
            Module(self.symbol, label_names=label_names, context=self.ctx)
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self._optimizer_params),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                monitor=monitor,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        import numpy as _np

        if self.arg_params is None:
            raise ValueError(
                "FeedForward: no trained parameters — fit() or load() first")
        data = self._as_iter(X)
        mod = self._bind_module(data, for_training=False)
        if return_data:
            # reference contract: (preds, datas, labels), gathered batchwise
            datas, labels = [], []
            if reset:
                data.reset()
            for batch in data:
                n = batch.data[0].shape[0] - (batch.pad or 0)
                datas.append(batch.data[0].asnumpy()[:n])
                if batch.label:
                    labels.append(batch.label[0].asnumpy()[:n])
                if num_batch is not None and len(datas) >= num_batch:
                    break
            data.reset()
        outs = mod.predict(data, num_batch=num_batch, reset=reset)
        if isinstance(outs, (list, tuple)):
            preds = [_np.asarray(o.asnumpy()) for o in outs]
            preds = preds[0] if len(preds) == 1 else preds
        else:
            preds = _np.asarray(outs.asnumpy())
        if return_data:
            return (preds, _np.concatenate(datas) if datas else None,
                    _np.concatenate(labels) if labels else None)
        return preds

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        from . import metric as _metric

        if self.arg_params is None:
            raise ValueError(
                "FeedForward: no trained parameters — fit() or load() first")
        data = self._as_iter(X)
        data.reset()
        mod = self._bind_module(data, for_training=False)
        m = _metric.create(eval_metric)
        mod.score(data, m, num_batch=num_batch)
        return m.get()[1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train and return a model in one call (reference: model.py
        FeedForward.create — the API the R binding's
        mx.model.FeedForward.create mirrors)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        return model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, logger=logger)
