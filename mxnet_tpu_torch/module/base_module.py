"""BaseModule: the fit/score/predict loop.

PyTorch counterpart of ``mxnet_tpu/module/base_module.py`` (reference:
python/mxnet/module/base_module.py).  ``fit`` takes the fused train step
(``Module._try_fused_step``) where the module allows it, else
``forward_backward`` + ``update`` (always for ``BucketingModule`` and
``SequentialModule``, which take no fused step, as the reference's).
``fit(shard_rules=...)`` hands the partition rules to the ``Module``.
``fit(checkpoint_dir=..., checkpoint_every=N, resume=True)`` checkpoints
the complete train state every N global steps on a background writer,
writes a final synchronous checkpoint and returns ``False`` on
SIGTERM/SIGINT (``checkpoint.TrainCheckpointer``, ``fault.preemption``),
and resumes mid-epoch from the newest valid checkpoint.
"""
from __future__ import annotations

import logging
import time
import numpy as _np

from .. import metric as _metric
from .. import ndarray as nd
from .. import observability as _obs
from ..initializer import Uniform
from ..model import BatchEndParam, _load_params_file, _save_params_file

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typ, throw):
    args = symbol.list_arguments()
    for name in names:
        if name not in args:
            msg = f"input {typ}={name} is not found in symbol.list_arguments"
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- to be implemented by subclasses ------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # -- shared training loops ----------------------------------------------------
    def forward_backward(self, data_batch):
        """reference: base_module.py:193"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _try_fused_step(self, data_batch) -> bool:
        """Run forward, backward and the optimizer update in one call when
        the concrete module supports it (Module overrides).  Returns True
        when the batch was handled; False routes fit() to the legacy
        forward_backward()+update() pair."""
        return False

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.prepare(eval_batch, sparse_row_id_fn=sparse_row_id_fn)
            self.forward(eval_batch, is_train=False)
            if isinstance(eval_batch, list):
                self.update_metric(eval_metric, [eb.label for eb in eval_batch],
                                   pre_sliced=True)
            else:
                self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def _pad_partial_batch(self, eval_batch):
        """Pad a final partial batch up to the bound batch size, so it
        takes the bound executor instead of a rebind; the extra rows are
        folded into ``batch.pad`` so the output slicing drops them."""
        try:
            bound = self.data_shapes
        except Exception:
            return eval_batch
        if (not bound or not eval_batch.data
                or len(bound) != len(eval_batch.data)):
            return eval_batch
        extras = []
        for (_, bshape), arr in zip(bound, eval_batch.data):
            if (len(arr.shape) != len(bshape)
                    or tuple(arr.shape[1:]) != tuple(bshape[1:])
                    or arr.shape[0] > bshape[0]):
                return eval_batch  # genuinely new shape: rebind path owns it
            extras.append(bshape[0] - arr.shape[0])
        if not any(extras) or len(set(extras)) != 1:
            return eval_batch
        from ..io import DataBatch
        from ..serving.bucketing import pad_batch_rows

        padded = [nd.array(pad_batch_rows(
            arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr),
            bshape[0]), ctx=getattr(arr, "context", None))
            for (_, bshape), arr in zip(bound, eval_batch.data)]
        # labels are not fed (prediction path) — keeping them un-padded
        # would change the executor signature right back
        return DataBatch(data=padded, label=None,
                         pad=(eval_batch.pad or 0) + extras[0],
                         index=eval_batch.index)

    def iter_predict(self, eval_data, num_batch=None, reset=True, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.prepare(eval_batch, sparse_row_id_fn=sparse_row_id_fn)
            eval_batch = self._pad_partial_batch(eval_batch)
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.prepare(eval_batch, sparse_row_id_fn=sparse_row_id_fn)
            eval_batch = self._pad_partial_batch(eval_batch)
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise ValueError("mismatched output count between batches")
            output_list2 = [nd.concat(*[out[i] for out in output_list], dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            sparse_row_id_fn=None, shard_rules=None, checkpoint_dir=None,
            checkpoint_every=0, checkpoint_keep=3, resume=False):
        """The canonical training loop (reference: base_module.py fit).

        ``shard_rules``: ordered ``(regex, PartitionSpec)`` partition rules
        for the ``mp`` mesh axis (``TPUMX_MP_DEVICES`` > 1), handed to the
        module's ``bind``.

        Fault tolerance: with ``checkpoint_dir`` set, fit snapshots the
        COMPLETE train state (parameters, optimizer state with AMP
        masters, the loss scaler, the random key, the iterator position)
        every ``checkpoint_every`` global steps for a background writer,
        keeping the last ``checkpoint_keep`` checkpoints, and installs a
        SIGTERM/SIGINT handler that writes a final SYNCHRONOUS checkpoint
        and returns from fit.  ``resume=True`` finds the newest *valid*
        checkpoint (corrupt or truncated ones are skipped by checksum for
        the previous one) and continues mid-epoch on the same loss
        trajectory.  Returns True when training ran to completion, False
        when it returned early on a preemption signal."""
        assert num_epoch is not None, "please specify number of epochs"
        if shard_rules is not None:
            self._shard_rules = shard_rules
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        # fault tolerance: periodic async checkpoints, a final synchronous
        # one on preemption, mid-epoch resume; inert without checkpoint_dir
        ckpt = None
        preempt = None
        resume_skip = 0
        global_step = 0
        if checkpoint_dir is not None:
            from ..checkpoint import TrainCheckpointer
            from ..fault.preemption import PreemptionHandler

            ckpt = TrainCheckpointer(self, checkpoint_dir,
                                     every=checkpoint_every,
                                     keep=checkpoint_keep)
            preempt = PreemptionHandler().install()
            ckpt.attach_preemption(preempt)
            if resume:
                point = ckpt.restore()
                if point is not None:
                    begin_epoch = point.epoch
                    resume_skip = point.nbatch
                    global_step = point.global_step
                    self.logger.info(
                        "resumed from checkpoint at step %d "
                        "(epoch %d, batch %d)", point.global_step,
                        point.epoch, point.nbatch)

        # per-batch host wall time (dispatch, no device sync added)
        step_hist = _obs.registry().histogram(
            "train_step_seconds",
            help="Module.fit per-batch host wall time (dispatch, no sync)")
        train_data.reset()  # defensive: support reused/exhausted iterators
        preempted = False
        # one trace context for the whole fit call: the fit, step and
        # checkpoint spans share a trace id, and the async checkpoint
        # writer inherits it across its thread (a no-op under
        # TPUMX_TRACING=0)
        trace_token = _obs.tracing.attach(_obs.tracing.new_trace())
        try:
            for epoch in range(begin_epoch, num_epoch):
                with _obs.span(f"fit.epoch[{epoch}]", cat="fit"):
                    global_step, preempted = self._fit_epoch(
                        epoch, train_data, eval_metric, monitor,
                        batch_end_callback, sparse_row_id_fn, ckpt,
                        step_hist, resume_skip if epoch == begin_epoch
                        else 0, global_step)
                    if preempted:
                        break
                    arg_p, aux_p = self.get_params()
                    self.set_params(arg_p, aux_p)
                    if epoch_end_callback is not None:
                        for cb in _as_list(epoch_end_callback):
                            cb(epoch, self.symbol, arg_p, aux_p)
                    if eval_data is not None:
                        res = self.score(
                            eval_data, validation_metric,
                            score_end_callback=eval_end_callback,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch)
                        for name, val in res:
                            self.logger.info("Epoch[%d] Validation-%s=%f",
                                             epoch, name, val)
                    train_data.reset()
        finally:
            _obs.tracing.detach(trace_token)
            if preempt is not None:
                preempt.uninstall()
            if ckpt is not None:
                ckpt.close()
        return not preempted

    def _fit_epoch(self, epoch, train_data, eval_metric, monitor,
                   batch_end_callback, sparse_row_id_fn, ckpt, step_hist,
                   skip, global_step):
        """One epoch of ``fit``: ``(global step, preempted)``; preempted
        means the final checkpoint is written and fit must return."""
        tic = time.time()
        eval_metric.reset()
        nbatch = 0
        data_iter = iter(train_data)
        if skip:
            from ..io import fast_forward

            nbatch = fast_forward(data_iter, skip)
        end_of_batch = False
        eval_name_vals = []
        try:
            next_data_batch = next(data_iter)
        except StopIteration:  # resumed exactly at the epoch's end
            end_of_batch = True
            eval_name_vals = eval_metric.get_name_value()
        while not end_of_batch:
            data_batch = next_data_batch
            if monitor is not None:
                monitor.tic()
            step_tic = time.perf_counter()
            with _obs.span("fit.batch", cat="fit"):
                if not self._try_fused_step(data_batch):
                    self.forward_backward(data_batch)
                    self.update()
                if isinstance(data_batch, list):
                    self.update_metric(eval_metric,
                                       [db.label for db in data_batch],
                                       pre_sliced=True)
                else:
                    self.update_metric(eval_metric, data_batch.label)
            step_hist.observe(time.perf_counter() - step_tic)
            global_step += 1
            if ckpt is not None and ckpt.after_batch(epoch, nbatch + 1,
                                                     global_step):
                # the final synchronous checkpoint is written; leave
                # without touching the iterator again
                self.logger.info(
                    "Epoch[%d] preempted at batch %d (step %d); final "
                    "checkpoint written, exiting fit", epoch, nbatch,
                    global_step)
                return global_step, True
            try:
                next_data_batch = next(data_iter)
                self.prepare(next_data_batch,
                             sparse_row_id_fn=sparse_row_id_fn)
            except StopIteration:
                end_of_batch = True
            if monitor is not None:
                monitor.toc_print()
            if end_of_batch:
                eval_name_vals = eval_metric.get_name_value()
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
            nbatch += 1
        for name, val in eval_name_vals:
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                         time.time() - tic)
        return global_step, False

    # -- misc ---------------------------------------------------------------------
    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        _save_params_file(fname, arg_params, aux_params)

    def load_params(self, fname):
        arg_params, aux_params = _load_params_file(fname)
        self.set_params(arg_params, aux_params)

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError
