"""Module: symbolic training on one device or a mesh of them.

PyTorch counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py).  One ``Executor`` holds the bound
arguments, gradients and aux states on the module's context (the current
context by default: ``gpu(0)``).  ``fit`` takes the fused train step
(``_try_fused_step``: ``Executor.fused_step``, forward + backward + the
optimizer's update in one call) whenever the reference would
(``_fused_ready``), else the legacy route: ``forward_backward`` and
``update`` through the ``Updater`` (and the kvstore's push and pull where
one is made).  Optimizer state lives in the ``Updater``'s slots on both
routes (index ``i * num_device``, ``num_device`` the context count), so
``save_optimizer_states``/``load_optimizer_states`` see one layout.  Over
a ``dist_*`` store the legacy route pushes gradients and pulls weights,
the update on the server; a ``dist_sync`` store's ``rescale_grad`` covers
every worker's batch.

Several devices, one process each (``parallel/mesh.py``; launch with
``tools/launch.py`` or ``torchrun``): several contexts or
``TPUMX_DP_DEVICES`` give the ``dp`` width, ``TPUMX_MP_DEVICES`` an
``mp`` axis whose partition rules (``shard_rules`` at ``bind``/``fit``,
``TPUMX_SHARD_RULES``, else every parameter fully sharded) store
parameters, gradients and optimizer state as blocks, and
``TPUMX_PP_DEVICES`` a ``pp`` axis over which a stage-stackable symbol's
body runs as a pipeline (``symbol/staging.py``;
``TPUMX_PP_MICROBATCHES``).  Where the widths exceed 1,
``_maybe_attach_spmd_mesh`` makes the mesh over the world, binds the
executor on this rank's device and attaches the mesh
(``Executor.set_spmd``); each rank reads the whole batch from its
iterator and the step cuts its block.  A mesh the world cannot hold (a
world of one with two contexts) is logged and the module trains on its
first context by the legacy route, as the reference does when its mesh
cannot be made.  ``get_params`` and the checkpoint files hold whole
arrays.  ``group2ctxs`` is accepted and unused, as in the reference.

AMP (``amp``): under ``TPUMX_AMP=1`` ``bind`` binds
``amp.convert_symbol(symbol, TPUMX_AMP_DTYPE)`` (``self._symbol``, the
argument names and the checkpoint files stay the original's) and
``init_optimizer`` makes the loss scaler ``TPUMX_AMP_LOSS_SCALE`` asks
for, which the fused step takes; where the fused step is not allowed the
scaler is dropped with a warning and the converted graph trains
unscaled, as in the reference.

Fault tolerance: ``capture_train_state``/``restore_train_state`` hand the
complete train state to ``checkpoint.TrainCheckpointer`` (``fit``'s
``checkpoint_dir``/``resume``); the fused step publishes its device-side
telemetry to the registry every ``TPUMX_TELEMETRY_EVERY`` steps.
``BucketingModule`` and ``SequentialModule`` (``bucketing_module.py``, ``sequential_module.py``)
drive ``Module``s through the legacy route.
"""
from __future__ import annotations

import logging
import os

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, context_of, current_context
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _fused_step_allowed, _initialize_kvstore,
                     _update_params, _update_params_on_kvstore,
                     load_checkpoint)
from ..ndarray.ndarray import NDArray
from ..optimizer import create as _create_optimizer, get_updater
from ..parallel import partition_rules as _pr
from ..parallel.mesh import make_mesh
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _env_width(name: str) -> int:
    try:
        return int(os.environ.get(name, "") or 0)
    except ValueError:
        return 0


def _copy_state(st):
    """A state's structure with new NDArray leaves over the same tensors."""
    if st is None:
        return None
    if isinstance(st, (tuple, list)):
        return tuple(_copy_state(s) for s in st)
    return NDArray(st._data)


def _tensor(v) -> torch.Tensor:
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(_np.ascontiguousarray(v))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = context
        self._group2ctxs = group2ctxs   # accepted, unused (the reference's)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._compression_params = compression_params
        self._fused_step_count = 0
        self._amp_cfg = None        # resolved at bind (TPUMX_AMP*)
        self._loss_scaler = None    # made at init_optimizer when needed
        self._shared_bound = False
        # ordered (regex, spec) partition rules from bind()/fit()
        self._shard_rules = None
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save(f"{prefix}-symbol.json")
        self.save_params(f"{prefix}-{epoch:04d}.params")
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    # -- properties ---------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec.outputs:
            return [(n, o.shape) for n, o in
                    zip(self._output_names, self._exec.outputs)]
        _, out_shapes, _ = self._symbol.infer_shape(**self._shape_kwargs())
        return list(zip(self._output_names, out_shapes))

    def _shape_kwargs(self):
        return dict(self._data_shapes + self._label_shapes)

    def _dp_size(self) -> int:
        """The data-parallel width: ``TPUMX_DP_DEVICES`` when above 1, else
        the number of contexts."""
        n = _env_width("TPUMX_DP_DEVICES")
        return n if n > 1 else len(self._context)

    def _mp_size(self) -> int:
        """The model-parallel width (``TPUMX_MP_DEVICES``)."""
        return max(1, _env_width("TPUMX_MP_DEVICES"))

    def _pp_size(self) -> int:
        """The pipeline width (``TPUMX_PP_DEVICES``)."""
        return max(1, _env_width("TPUMX_PP_DEVICES"))

    # -- binding ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", shard_rules=None):
        if shard_rules is not None:
            self._shard_rules = shard_rules
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        def _norm(shapes):
            out = []
            for s in shapes or []:
                if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], str):
                    out.append((s[0], tuple(s[1])))
                else:  # DataDesc
                    out.append((s.name, tuple(s.shape)))
            return out

        self._data_shapes = _norm(data_shapes)
        self._label_shapes = _norm(label_shapes)
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._state_names:
                req[n] = "null"
            elif n in self._fixed_param_names or not for_training:
                req[n] = "null"
            else:
                req[n] = grad_req
        spmd = self._spmd_mesh_for_bind()
        ctx = self._context[0] if spmd is None \
            else context_of(spmd[0].device)
        # AMP: the converted graph is bound, self._symbol stays the
        # original (arguments, checkpoints)
        from .. import amp as _amp

        self._amp_cfg = _amp.active_config()
        bind_symbol = self._symbol
        if self._amp_cfg is not None:
            bind_symbol = _amp.convert_symbol(self._symbol,
                                              self._amp_cfg.dtype)
        self._exec = bind_symbol.simple_bind(
            ctx=ctx, grad_req=req, **self._shape_kwargs())
        if spmd is not None:
            self._attach_spmd_mesh(*spmd)
        self._shared_bound = shared_module is not None
        if shared_module is not None and shared_module._exec is not None:
            self._exec.copy_params_from(*shared_module.get_params())
        if self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    def _spmd_mesh_for_bind(self):
        """``(mesh, rules, pipeline)`` when this module trains over a mesh
        (widths above 1, reference: ``_maybe_attach_spmd_mesh``), else
        None.  Rule axes are checked first (an unknown axis raises); a mesh
        the world cannot hold is logged and leaves the legacy route."""
        ndev, mp, pp = self._dp_size(), self._mp_size(), self._pp_size()
        if (ndev * mp * pp <= 1 or not self.for_training or self._state_names
                or os.environ.get("TPUMX_FUSED_STEP", "1") == "0"
                or os.environ.get("TPUMX_FUSED_STEP_SPMD", "1") == "0"):
            return None
        rules = None
        if mp > 1:
            env_rules = _pr.rules_from_env()
            rules = self._shard_rules or env_rules or _pr.DEFAULT_FSDP_RULES
            axes = ("dp",) + (("pp",) if pp > 1 else ()) + ("mp",)
            _pr.validate_rule_axes(
                rules, axes,
                source=("TPUMX_SHARD_RULES" if self._shard_rules is None
                        and env_rules is not None else "shard_rules"))
        pipeline = self._plan_pipeline(ndev, pp) if pp > 1 else None
        if pipeline is None:
            pp = 1
        axes = {"dp": ndev}
        if pp > 1:
            axes["pp"] = pp
        if mp > 1:
            axes["mp"] = mp
        if ndev * mp * pp <= 1:
            return None
        try:
            mesh = make_mesh(axes, install=False, device=self._context[0])
        except MXNetError as e:
            self.logger.warning(
                "SPMD fused step unavailable (%s); multi-device fit will use "
                "the legacy executor-group path", e)
            return None
        return mesh, rules, pipeline

    def _attach_spmd_mesh(self, mesh, rules, pipeline):
        param_specs, compute = None, False
        if "mp" in mesh.axis_names:
            shapes = {n: tuple(self._exec.arg_dict[n].shape)
                      for n in self._param_names
                      if n not in self._fixed_param_names
                      and n in self._exec.arg_dict}
            param_specs = _pr.make_param_specs(rules, shapes, mesh,
                                               mp_axis="mp")
            # explicit column/row rule sets partition the compute; the
            # FSDP catch-all keeps gather-compute-slice; under pp mp stays
            # a storage axis
            compute = (pipeline is None and _pr.mp_compute_enabled()
                       and _pr.rules_compute_partitionable(rules))
        try:
            self._exec.set_spmd(
                mesh, batch_args=self._data_names + self._label_names,
                param_specs=param_specs, compute=compute, pipeline=pipeline)
        except MXNetError as e:
            self.logger.warning(
                "SPMD fused step unavailable (%s); multi-device fit will use "
                "the legacy executor-group path", e)

    def _plan_pipeline(self, ndev, pp):
        """(plan, n_micro) when the bound symbol splits into ``pp`` stages
        and the microbatch count divides the per-dp-rank batch; None (with
        a logged reason) otherwise."""
        from ..symbol.staging import PlanError, plan_pipeline

        batch = self._data_shapes[0][1][0] if self._data_shapes else 0
        if not batch or batch % ndev:
            return None
        local_batch = batch // ndev
        env = os.environ.get("TPUMX_PP_MICROBATCHES", "")
        n_micro = _env_width("TPUMX_PP_MICROBATCHES")
        if not n_micro:
            n_micro = next((m for m in (4 * pp, 2 * pp, pp)
                            if m <= local_batch and local_batch % m == 0), 0)
        if n_micro < 1 or local_batch % n_micro:
            self.logger.warning(
                "pipeline: local batch %d has no usable microbatch count "
                "(TPUMX_PP_MICROBATCHES=%s); dropping the pp axis",
                local_batch, env or "auto")
            return None
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **self._shape_kwargs())
        structs = {n: torch.empty(s, device="meta") for n, s in zip(
            self._symbol.list_arguments() + self._aux_names,
            list(arg_shapes) + list(aux_shapes))}
        try:
            plan = plan_pipeline(
                self._symbol._entries, pp, structs,
                input_names=(self._data_names + self._label_names
                             + self._state_names))
        except PlanError as e:
            self.logger.warning(
                "pipeline: symbol is not stage-stackable (%s); dropping "
                "the pp axis", e)
            return None
        self.logger.info("pipeline: %s, %d microbatches", plan.describe(),
                         n_micro)
        return (plan, n_micro)

    # -- params -------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the bound parameters and aux states from ``arg_params``/
        ``aux_params`` (NDArrays, tensors or numpy arrays, copied), else
        with ``initializer`` by name."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        attrs = self._symbol.attr_dict()
        for names, given, bound, what in (
                (self._param_names, arg_params, self._exec.arg_dict,
                 "parameter"),
                (self._aux_names, aux_params, self._exec.aux_dict,
                 "aux state")):
            for name in names:
                arr = bound[name]._data
                if given is not None and name in given:
                    src = self._exec.spmd_block(name, _tensor(given[name]))
                    if tuple(src.shape) != tuple(arr.shape):
                        raise MXNetError(
                            f"{what} {name}: given shape "
                            f"{tuple(src.shape)}, bound as {tuple(arr.shape)}")
                    with torch.no_grad():
                        arr.copy_(src)
                elif given is not None and not allow_missing:
                    # a partial checkpoint with allow_missing=False raises,
                    # not silently falls through to the initializer
                    raise MXNetError(
                        f"{what} {name} not present in "
                        f"{'arg' if what == 'parameter' else 'aux'}_params "
                        "(pass allow_missing=True to initialize it instead)")
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)
                elif not allow_missing and what == "parameter":
                    raise MXNetError(
                        f"missing parameter {name} and no initializer given")
        self.params_initialized = True
        self._params_dirty = False
        self._sync_params_from_exec()

    def _sync_params_from_exec(self):
        self._arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        self._aux_params = dict(self._exec.aux_dict)

    def get_params(self):
        """Copies of the parameters and aux states, whole: under partition
        rules each rank's blocks are gathered (every rank calls it)."""
        assert self.params_initialized
        self._sync_params_from_exec()
        whole = self._exec.spmd_whole
        return ({k: NDArray(whole(k, v._data).clone())
                 for k, v in self._arg_params.items()},
                {k: v.copy() for k, v in self._aux_params.items()})

    # -- optimizer ----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        # the effective dp width: above 1 makes the collective store
        kv, update_on_kvstore = _create_kvstore(
            kvstore, self._dp_size(),
            {n: self._exec.arg_dict[n] for n in self._param_names})
        batch_size = self._data_shapes[0][1][0] if self._data_shapes else 1
        if kv and "dist" in kv.type and "_sync" in kv.type:
            batch_size *= kv.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            # the updater indexes params as i*num_device+k
            # (model._update_params): idx2name covers every device slot
            ndev = len(self._context)
            idx2name = {i * ndev + k: n
                        for i, n in enumerate(self._param_names)
                        for k in range(ndev)}
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = _create_optimizer(optimizer, sym=self._symbol,
                                          param_idx2name=idx2name,
                                          **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            _initialize_kvstore(
                kvstore=kv,
                param_arrays=[[self._exec.arg_dict[n]] for n in self._param_names],
                arg_params={n: self._exec.arg_dict[n] for n in self._param_names},
                param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = get_updater(self._optimizer)
        # made once per optimizer init: its (scale, good_steps) carries
        # over batches, epochs and rebinds
        from .. import amp as _amp

        self._loss_scaler = _amp.make_loss_scaler(self._amp_cfg)
        if self._loss_scaler is not None and not _fused_step_allowed(
                self._optimizer, self._kvstore, self._update_on_kvstore,
                self._dp_size()):
            self.logger.warning(
                "AMP loss scaling requires the fused train step; this "
                "configuration falls back to the legacy path and trains "
                "UNSCALED")
            self._loss_scaler = None
        self.optimizer_initialized = True
        if hasattr(self, "_preload_opt_states"):
            self.load_optimizer_states(self._preload_opt_states)
            del self._preload_opt_states

    # -- compute ------------------------------------------------------------
    def _feed(self, data_batch):
        """The batch's arrays by argument name; a batch of another data
        shape rebinds first."""
        feed = dict(zip([n for n, _ in self._data_shapes], data_batch.data))
        if self._label_shapes and data_batch.label:
            feed.update(zip([n for n, _ in self._label_shapes],
                            data_batch.label))
        cur = dict(self._data_shapes)
        if any(cur[n] != tuple(a.shape) for n, a in
               zip([s[0] for s in self._data_shapes], data_batch.data)):
            self._reshape_exec(data_batch)
        return feed

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = self._feed(data_batch)
        self._exec.forward(is_train=is_train, **feed)

    def _reshape_exec(self, data_batch):
        data_shapes = [(n, tuple(a.shape)) for (n, _), a in
                       zip(self._data_shapes, data_batch.data)]
        label_shapes = None
        if self._label_shapes and data_batch.label:
            label_shapes = [(n, tuple(a.shape)) for (n, _), a in
                            zip(self._label_shapes, data_batch.label)]
        arg_params, aux_params = self.get_params()
        self.binded = False
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True)
        self._exec.copy_params_from(arg_params, aux_params, allow_extra_params=True)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    # -- fused train step ---------------------------------------------------
    def _fused_ready(self) -> bool:
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return False
        ndev = self._dp_size()
        if not _fused_step_allowed(self._optimizer, self._kvstore,
                                   self._update_on_kvstore, ndev):
            return False
        if self._updater is None or self._shared_bound or self.inputs_need_grad:
            return False
        if self._exec is None or self._exec._grouped is not None:
            return False
        if self._exec._monitor_callback is not None:
            return False  # per-step introspection wants the legacy path
        # every gradient-taking argument must be a parameter we update
        if set(self._exec._grad_arg_names) - set(self._param_names):
            return False
        if ndev > 1:
            # the mesh must be attached and the batch divide over dp
            if self._exec._spmd_ndev() != ndev:
                return False
            batch = self._data_shapes[0][1][0] if self._data_shapes else 0
            if not batch or batch % ndev:
                return False
        if self._mp_size() > 1:
            mesh = self._exec._spmd_mesh
            if mesh is None or "mp" not in mesh.axis_names:
                return False
            if self._exec._spmd_param_specs and not getattr(
                    self._optimizer, "update_step_elementwise", True):
                return False
        return True

    def _try_fused_step(self, data_batch) -> bool:
        """Forward, backward and the optimizer update in one
        ``Executor.fused_step`` call.  The optimizer state lives in the
        ``Updater``'s slots (index ``i * num_device``, as the legacy route
        numbers them)."""
        if not self._fused_ready():
            return False
        grad_names = set(self._exec._grad_arg_names)
        nslot = len(self._context)
        idx_of = {n: i * nslot for i, n in enumerate(self._param_names)
                  if n in grad_names}
        counts = {self._optimizer._index_update_count.get(
            i, self._optimizer.begin_num_update) for i in idx_of.values()}
        if len(counts) > 1:
            return False
        feed = self._feed(data_batch)
        updates, states = [], {}
        for name, idx in idx_of.items():
            if idx in self._updater._loaded:
                # a state read from a file is whole: this rank's block
                self._exec.spmd_state_map(name, self._updater.states[idx],
                                          self._exec.spmd_block)
            states[name] = self._updater._state(idx, self._exec.arg_dict[name])
            updates.append((name, idx))
        self._exec.fused_step(self._optimizer, states, updates, feed=feed,
                              num_steps=1, kvstore=self._kvstore,
                              loss_scaler=self._loss_scaler)
        self._params_dirty = True
        self._fused_step_count += 1
        # telemetry stays on the device across steps; every
        # TPUMX_TELEMETRY_EVERY-th step reads its scalars into gauges
        if self._exec._telemetry_last is not None:
            from ..observability import telemetry as _tele

            if self._fused_step_count % _tele.every() == 0:
                _tele.publish(self._exec.telemetry_snapshot())
        return True

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        param_arrays = [[self._exec.arg_dict[n]] for n in self._param_names]
        grad_arrays = [[self._exec.grad_dict.get(n)] for n in self._param_names]
        if self._update_on_kvstore:
            _update_params_on_kvstore(param_arrays, grad_arrays, self._kvstore,
                                      self._param_names)
        else:
            _update_params(param_arrays, grad_arrays, updater=self._updater,
                           num_device=len(self._context), kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._output_names, self._exec.outputs)),
            device=True)

    # -- states -------------------------------------------------------------
    def get_states(self, merge_multi_context=True):
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        if states is not None:
            for n, s in zip(self._state_names, states):
                self._exec.arg_dict[n]._data = _tensor(s).to(
                    self._exec.arg_dict[n]._data.device)
        elif value is not None:
            for n in self._state_names:
                self._exec.arg_dict[n][:] = value

    def save_optimizer_states(self, fname):
        """The reference's file; under partition rules each state is
        gathered whole first (every rank calls it)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        held = self._updater.states
        if self._exec._spmd_blocks:
            nslot = len(self._context)
            name_of = {i * nslot: n for i, n in enumerate(self._param_names)}
            whole = {}
            for idx, st in held.items():
                st = _copy_state(st)
                self._exec.spmd_state_map(name_of.get(idx), st,
                                          self._exec.spmd_whole)
                whole[idx] = st
            self._updater.states = whole
        try:
            data = self._updater.get_states()
        finally:
            self._updater.states = held
        with open(fname, "wb") as f:
            f.write(data)

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        arg_params, aux_params = self.get_params()
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True)
        self._exec.copy_params_from(arg_params, aux_params, allow_extra_params=True)

    # -- fault tolerance ----------------------------------------------------
    def capture_train_state(self):
        """The COMPLETE train state (parameters, aux, optimizer state with
        AMP masters, optimizer counters, loss scaler, random key) as
        ``(arrays, opt_tree, meta)``: clones the next step cannot touch,
        what one fault-tolerant checkpoint holds."""
        from ..checkpoint.train_state import capture_train_state

        return capture_train_state(self)

    def restore_train_state(self, info, arrays, opt_tree):
        """Install a checkpoint loaded by ``CheckpointManager.restore``
        into this bound module; returns the ``ResumePoint``."""
        from ..checkpoint.train_state import restore_train_state

        return restore_train_state(self, info, arrays, opt_tree)

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
