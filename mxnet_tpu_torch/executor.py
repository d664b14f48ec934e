"""Executor: a symbol bound to arrays on one device.

PyTorch counterpart of ``mxnet_tpu/executor.py`` (reference:
``GraphExecutor``, ``Forward``/``Backward``).  The reference traces the
whole graph into one XLA program; here the graph is evaluated node by node
in Python (``symbol.graph.trace``), each op dispatching its torch kernels
(or the port's CUDA kernels) as it runs, and gradients are torch autograd
over that evaluation.  There is no program cache to port; the host cost of
per-node dispatch is what ``chip_smoke.py``'s ``module_fit`` phase reports
as the executor's host ms a forward.

- ``forward(is_train=True)`` evaluates the graph with the gradient-taking
  arguments as autograd leaves (aliases of the bound buffers) and keeps
  the graph; ``outputs`` hold the values detached.  A training BatchNorm
  writes its new moving statistics into ``aux_dict`` in place;
  ``is_train=False`` reads them.
- ``backward(out_grads=None)`` differentiates the outputs seeded with
  ones (``_ones_cotangent``; the loss heads ignore the seed unless
  ``out_grad``) or with ``out_grads``, and writes each gradient into its
  bound buffer (``grad_req`` ``write``) or adds it (``add``).  The graph
  is released after the first backward; the gradients stay cached, so a
  second ``backward()`` commits them again, as the reference's does.
- ``fused_step`` is forward, backward and the optimizer's update of every
  gradient-taking argument in one call over the executor's own buffers:
  SGD's is one ``torch._foreach_*`` pass (``Optimizer.
  update_multi_precision_list``), the other optimizers update per
  parameter.  Gradient buffers are allocated like their weights
  (``zeros_like``), so the ``_foreach`` pass meets one memory layout and
  stays multi-tensor.
- Random nodes (``Dropout``): each forward draws one key from the stream
  (``mxnet_tpu_torch.random``) and a random node takes ``fold_in(key,
  node uid)``, as the reference's ``trace``; ``fused_step`` draws one a
  call and folds in the step index when it runs several.

Several devices, one process per device (``parallel/mesh.py``):

- ``set_spmd(mesh, batch_args, ...)`` attaches a mesh (the reference's
  validation and messages).  ``fused_step`` then takes the mesh route
  whenever a mesh is attached, a world of one included: each rank runs
  forward and backward on its block of the batch (cut on the ``dp``
  axis), the gradients are summed over ``dp`` in one buffer per dtype
  (``collectives.psum_flat``), a training BatchNorm's new running
  statistics are averaged over ``dp``, outputs that carry the batch are
  gathered whole on every rank and the others averaged (reference:
  ``executor.py`` ``_get_fused_step``'s ``shard_map`` program).
- ``param_specs`` (from ``parallel.partition_rules.make_param_specs``):
  each rank stores its block of every rule-matched parameter, gradient
  and optimizer state from the first mesh step on; the step gathers the
  whole weights, differentiates, slices each summed gradient back and
  updates block-wise (FSDP storage).  With ``compute=True`` the step
  partitions the graph explicitly instead (``symbol.tensor_parallel``:
  column- and row-parallel ``FullyConnected``, elementwise ops passing the
  split through, any other node gathering its operand whole).
- ``pipeline=(plan, n_micro)`` (``symbol.staging.PipelinePlan``) runs the
  plan's body as GPipe over the mesh's ``pp`` ranks; prologue and stage
  gradients are summed over ``pp``.
- ``forward``/``backward`` on a mesh compute the whole batch on every
  rank from the whole weights: the reference's global outputs and
  gradients (its plain programs are global-view), with no collective in
  the graph.
- ``group2ctx`` (``symbol.placement.GroupedProgram``): each group's nodes
  run on its device in one process, arguments, gradients and aux states
  placed on the device of the group that reads them; ``fused_step``
  refuses it, as the reference's does.

AMP (``amp``): ``fused_step(loss_scaler=)`` seeds the floating outputs'
cotangents with the scale, counts the non-finite entries of the summed
gradients (summed again over every mesh axis on the mesh route, so every
rank takes the same branch), unscales them, and on overflow skips the
update, the optimizer state and the aux commit while the update counts
advance, as the reference's skipped program does; the scaler's ``(scale,
good_steps)`` stays on the device, and the finite verdict is the step's
one host read.

Telemetry (``observability.telemetry``, on unless ``TPUMX_TELEMETRY=0``):
after each fused step the gradient and parameter norms, the step loss,
the non-finite count (the loss-scale check's own count where there is
one), the skipped-step flag and the loss scale are computed as device
scalars from the summed gradients and the updated parameters, and kept
(``telemetry_snapshot``); nothing is read on the host.

Checkpoints: ``snapshot_arrays`` clones the bound arguments and aux
states on the current stream (the step updates its buffers in place),
whole where the mesh stores blocks.

Sparse input: an argument bound as a ``CSRNDArray`` (``stype="csr"``
declared on its variable, or ``simple_bind(stype_dict=)``) holds no dense
buffer.  A feed (``forward``, ``fused_step``) moves the batch's ``data``,
``indices`` and ``indptr`` onto the argument's device, and the graph sees
an ``ops.spatial.CsrTensor``, which ``dot`` takes as its left operand.
Such an argument takes no gradient (its ``grad_req`` must be ``null``)
and is no batch argument of a mesh (``set_spmd`` refuses it by name).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import random as _random
from .base import MXNetError
from .context import Context, resolve_device
from .ndarray.ndarray import NDArray
from .ndarray.sparse import CSRNDArray
from .symbol.graph import release_plan, topo_order, trace

__all__ = ["Executor", "check_csr_grad_req"]


def check_csr_grad_req(stypes: Dict[str, str], req: Dict[str, str]) -> None:
    """A csr argument takes no gradient: raise for a non-null request."""
    for n in stypes:
        if req.get(n, "null") != "null":
            raise MXNetError(
                f"argument {n!r} is bound with storage type csr and takes "
                f"no gradient: its grad_req must be 'null', got "
                f"{req[n]!r}")


def _ones_cotangent(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x)


def _seeds(outs, scale=None) -> List[torch.Tensor]:
    """The outputs' cotangent seeds: ones, times the loss scale for the
    floating outputs when one is given."""
    if scale is None:
        return [_ones_cotangent(o) for o in outs]
    from .amp.loss_scaler import LossScaler

    return [LossScaler.scale_cotangent(_ones_cotangent(o), scale)
            if o.is_floating_point() else _ones_cotangent(o) for o in outs]


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (an NDArray, tensor or array-like) as a tensor on ``like``'s
    device in ``like``'s dtype."""
    t = v._data if isinstance(v, NDArray) else v
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    return t.detach().to(device=like.device, dtype=like.dtype)


class Executor:
    def __init__(self, symbol, ctx: Context, args: Dict[str, NDArray],
                 args_grad: Dict[str, NDArray], grad_req: Dict[str, str],
                 aux_states: Dict[str, NDArray], group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = args
        self.grad_dict = args_grad or {}
        self.grad_req = grad_req
        self.aux_dict = aux_states or {}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._out_names = symbol.list_outputs()
        self._order = topo_order(symbol._entries)
        # each node's value is dropped after its last consumer has run, so
        # a forward holds only what autograd saved and what is still ahead
        self._release = release_plan(symbol._entries, self._order)
        self._outputs: List[NDArray] = []
        self._graph = None          # (outputs, leaves) of a training forward
        self._cached_grads: Optional[Dict[str, torch.Tensor]] = None
        self._forwarded = False
        self._last_rng = None
        self._monitor_callback = None
        self._csr_args = frozenset(n for n, a in args.items()
                                   if isinstance(a, CSRNDArray))
        check_csr_grad_req(dict.fromkeys(self._csr_args, "csr"),
                           self.grad_req)
        self._grad_arg_names = sorted(
            n for n in self._arg_names if self.grad_req.get(n, "null") != "null"
            and n in self.grad_dict)
        # the attached mesh (set_spmd) and what it carries
        self._spmd_mesh = None
        self._spmd_axis = "dp"
        self._spmd_param_specs: Dict[str, tuple] = {}
        self._spmd_batch_args: frozenset = frozenset()
        self._spmd_batch = 0
        self._spmd_out_is_batch: List[bool] = []
        self._spmd_compute = False
        self._spmd_tp = None            # TensorParallelPlan under compute
        self._spmd_pipeline = None      # (PipelinePlan, n_micro)
        # parameters stored as this rank's block: name -> whole shape
        self._spmd_blocks: Dict[str, tuple] = {}
        self._group2ctx = group2ctx
        self._grouped = None
        # train telemetry: the last fused step's device scalars and the
        # running sums of the accumulating ones
        self._telemetry_last: Optional[Dict[str, torch.Tensor]] = None
        self._telemetry_accum: Dict[str, torch.Tensor] = {}
        # this rank's non-finite gradient counts of the last loss-scale
        # check: (other gradients, block gradients)
        self._step_nonfinite = None
        if group2ctx:
            from .symbol.placement import GroupedProgram

            self._grouped = GroupedProgram(symbol, group2ctx, ctx)
            # each argument, its gradient and each aux state on the device
            # of the group that reads it (the reference's AssignContext)
            for d in (self.arg_dict, self.grad_dict, self.aux_dict):
                for n, a in d.items():
                    if a is not None and a._data is not None:
                        a._data = a._data.to(self._grouped.arg_device(n))

    # -- public mirror of the reference Executor API ------------------------
    @property
    def outputs(self) -> List[NDArray]:
        return self._outputs

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._out_names, self._outputs))

    # -- the mesh -----------------------------------------------------------
    def set_spmd(self, mesh, batch_args, axis: str = "dp",
                 param_specs=None, compute: bool = False,
                 pipeline=None) -> None:
        """Attach a mesh (``parallel.mesh.Mesh``) to this executor, or
        detach with ``mesh=None`` (reference: ``Executor.set_spmd``).
        ``batch_args`` carry the batch dimension and are cut on ``axis``;
        ``param_specs`` (name -> spec) store parameters as blocks;
        ``compute=True`` partitions the graph along the specs (tensor
        parallelism); ``pipeline=(plan, n_micro)`` runs the plan's body
        over the ``pp`` axis (module doc)."""
        if mesh is None:
            if self._spmd_blocks:
                self._spmd_to_whole()
            self._spmd_mesh = None
            self._spmd_batch_args = frozenset()
            self._spmd_param_specs = {}
            self._spmd_out_is_batch = []
            self._spmd_compute = False
            self._spmd_tp = None
            self._spmd_pipeline = None
            return
        ndev = int(mesh.shape[axis])
        batch_args = frozenset(batch_args)
        bdims = set()
        for n in batch_args:
            if n not in self.arg_dict:
                raise MXNetError(f"set_spmd: unknown batch argument {n!r}")
            if n in self._csr_args:
                raise MXNetError(
                    f"set_spmd: batch argument {n!r} is bound with storage "
                    f"type csr; the mesh step cuts dense batches only")
            shape = self.arg_dict[n].shape
            if not shape:
                raise MXNetError(f"set_spmd: batch argument {n!r} is scalar")
            bdims.add(shape[0])
        if len(bdims) != 1:
            raise MXNetError(
                f"set_spmd: batch arguments disagree on the leading "
                f"(batch) dimension: {sorted(bdims)}")
        (batch,) = bdims
        if batch % ndev:
            raise MXNetError(
                f"set_spmd: batch size {batch} not divisible by the dp "
                f"mesh size {ndev}")
        # outputs that carry the batch (shape inference at the bound
        # global shapes) are gathered whole; the others averaged
        shape_kwargs = {n: self.arg_dict[n].shape for n in self._arg_names}
        _, out_shapes, _ = self._symbol.infer_shape(**shape_kwargs)
        out_is_batch = [bool(s) and len(s) > 0 and s[0] == batch
                        for s in out_shapes]
        specs = {}
        if param_specs:
            from .parallel.partition_rules import spec_tuple

            for n, sp in param_specs.items():
                if n not in self.arg_dict:
                    raise MXNetError(
                        f"set_spmd: partition spec for unknown argument "
                        f"{n!r}")
                if n in batch_args:
                    raise MXNetError(
                        f"set_spmd: {n!r} is a batch argument; batch args "
                        f"shard on the {axis!r} axis, not via param_specs")
                st = spec_tuple(sp)
                if any(e is not None for e in st):
                    specs[n] = st
        if pipeline is not None:
            plan, n_micro = pipeline
            if "pp" not in mesh.axis_names:
                raise MXNetError("set_spmd: pipeline requires a 'pp' mesh "
                                 "axis")
            if int(plan.n_stages) != int(mesh.shape["pp"]):
                raise MXNetError(
                    f"set_spmd: plan has {plan.n_stages} stages but the pp "
                    f"axis is {int(mesh.shape['pp'])} wide")
            local_batch = batch // ndev
            if int(n_micro) < 1 or local_batch % int(n_micro):
                raise MXNetError(
                    f"set_spmd: local batch {local_batch} not divisible by "
                    f"{n_micro} microbatches (TPUMX_PP_MICROBATCHES)")
            pipeline = (plan, int(n_micro))
        if self._spmd_blocks:
            self._spmd_to_whole()
        self._spmd_mesh = mesh
        self._spmd_axis = axis
        self._spmd_param_specs = specs
        self._spmd_batch_args = batch_args
        self._spmd_batch = batch
        self._spmd_out_is_batch = out_is_batch
        # the pipelined step stores the specs' blocks but computes whole
        # weights: compute partitioning only on a pipeline-free mesh
        self._spmd_compute = bool(compute and specs and pipeline is None
                                  and "mp" in mesh.axis_names)
        self._spmd_tp = None
        if self._spmd_compute:
            from .symbol.tensor_parallel import TensorParallelPlan

            self._spmd_tp = TensorParallelPlan(self._symbol._entries, specs)
        self._spmd_pipeline = pipeline

    def _spmd_ndev(self) -> int:
        if self._spmd_mesh is None:
            return 1
        return int(self._spmd_mesh.shape[self._spmd_axis])

    @property
    def mp_gathers(self) -> Dict[str, Dict[str, int]]:
        """Under tensor-parallel compute: the gathers the partitioned steps
        made, ``{"weights": {param: n}, "operands": {node: n}}``."""
        tp = self._spmd_tp
        return {"weights": dict(tp.weight_gathers) if tp else {},
                "operands": dict(tp.operand_gathers) if tp else {}}

    def _sharding(self, name):
        from .parallel.mesh import NamedSharding, PartitionSpec

        return NamedSharding(self._spmd_mesh,
                             PartitionSpec(*self._spmd_param_specs[name]))

    def spmd_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` when ``name`` is stored as blocks and
        ``t`` is whole; else ``t``."""
        full = self._spmd_blocks.get(name)
        if full is None or tuple(t.shape) != full:
            return t
        from .parallel.mesh import shard

        return shard(t.detach(), self._sharding(name))

    def spmd_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of ``t`` (this rank's block of ``name``) gathered from
        every rank (a collective: every rank calls it); ``t`` itself when
        ``name`` is not stored as blocks or ``t`` is whole already."""
        full = self._spmd_blocks.get(name)
        if full is None or tuple(t.shape) == full:
            return t
        from .parallel.mesh import gather

        with torch.no_grad():
            return gather(t.detach(), self._sharding(name))

    def spmd_state_map(self, name: str, state, fn):
        """Apply ``fn(name, tensor)`` to every leaf of an optimizer state
        (an NDArray, a tuple of them, or None), in place."""
        if state is None:
            return
        if isinstance(state, (tuple, list)):
            for s in state:
                self.spmd_state_map(name, s, fn)
            return
        state._data = fn(name, state._data)

    def _spmd_to_blocks(self, states) -> None:
        """Store every rule-matched parameter, its gradient and its
        optimizer state as this rank's block (once; a whole tensor loaded
        later is cut again)."""
        for n in self._spmd_param_specs:
            if n not in self._spmd_blocks:
                self._spmd_blocks[n] = tuple(self.arg_dict[n].shape)
            for d in (self.arg_dict, self.grad_dict):
                if n in d:
                    d[n]._data = self.spmd_block(n, d[n]._data)
            if n in states:
                self.spmd_state_map(n, states[n], self.spmd_block)

    def _spmd_to_whole(self) -> None:
        for n in list(self._spmd_blocks):
            for d in (self.arg_dict, self.grad_dict):
                if n in d:
                    d[n]._data = self.spmd_whole(n, d[n]._data)
        self._spmd_blocks = {}

    # -- train telemetry ----------------------------------------------------
    def _note_telemetry(self, vals: Dict[str, torch.Tensor]) -> None:
        """Keep one fused step's telemetry: the accumulating keys add up
        (on the device), the others keep the last step's value."""
        from .observability import telemetry as _tele

        self._telemetry_last = dict(vals)
        for k in _tele.ACCUMULATING:
            v = vals.get(k)
            if v is None:
                continue
            prev = self._telemetry_accum.get(k)
            self._telemetry_accum[k] = v if prev is None else prev + v

    def telemetry_snapshot(self) -> Dict[str, torch.Tensor]:
        """The telemetry device scalars: the last step's values, with the
        non-finite and skip counters replaced by their totals across
        steps.  Hand them to ``observability.telemetry.publish`` at a log
        boundary (the one host read)."""
        if self._telemetry_last is None:
            return {}
        out = dict(self._telemetry_last)
        out.update(self._telemetry_accum)
        return out

    def _step_telemetry(self, outs, loss_scaler) -> Dict[str, torch.Tensor]:
        from .observability import telemetry as _tele

        grads = self._cached_grads or {}
        names = [n for n in self._grad_arg_names if n in grads]
        grads = {n: grads[n] for n in names}
        params = {n: self.arg_dict[n]._data for n in names}

        def cut(tree):
            # the names whose tensor here is this rank's block, not whole
            return [n for n, t in tree.items() if n in self._spmd_blocks
                    and tuple(t.shape) != self._spmd_blocks[n]]

        g_blk, p_blk = cut(grads), cut(params)
        global_sum = None
        if g_blk or p_blk:
            from .parallel.collectives import psum_flat

            axes = tuple(sorted({a for n in set(g_blk) | set(p_blk)
                                 for part in self._spmd_param_specs[n]
                                 if part is not None
                                 for a in (part if isinstance(
                                     part, (tuple, list)) else (part,))}))

            def global_sum(xs):
                return psum_flat(xs, axes, self._spmd_mesh)
        sc = None
        if loss_scaler is not None:
            sc = loss_scaler.state(params[names[0]].device if names
                                   else None)
        return _tele.compute(outs, grads, params, scaler_state=sc,
                             nonfinite=self._step_nonfinite,
                             sharded_grads=g_blk,
                             sharded_params=p_blk, global_sum=global_sum)

    # -- checkpoint capture -------------------------------------------------
    def snapshot_arrays(self, include_aux: bool = True):
        """Copies of the bound arguments (and aux states) that the next
        step cannot touch: ``({name: tensor}, {aux_name: tensor})``.

        The fused step updates weights and optimizer state in place, so
        each buffer is cloned on the current stream (no host sync): the
        clones are ordered before the next step's update, and a reader on
        another stream waits on an event recorded after them
        (``checkpoint.CheckpointManager.save``).  A parameter stored as
        this rank's block is gathered whole first (a collective: every
        rank calls it), so a checkpoint holds whole arrays and restores
        under any mesh shape."""
        with torch.no_grad():
            args = {n: self.spmd_whole(n, self.arg_dict[n]._data).clone()
                    for n in self._arg_names
                    if n in self.arg_dict and n not in self._csr_args
                    and self.arg_dict[n]._data is not None}
            aux = {}
            if include_aux:
                aux = {n: self.aux_dict[n]._data.clone()
                       for n in self._aux_names
                       if n in self.aux_dict
                       and self.aux_dict[n]._data is not None}
        return args, aux

    # -- evaluation ---------------------------------------------------------
    def _feed(self, feed) -> None:
        for k, v in (feed or {}).items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k!r}")
            if k in self._csr_args:
                self._feed_csr(self.arg_dict[k], v)
                continue
            t = _as_tensor(v, self.arg_dict[k]._data)
            if self._spmd_mesh is not None and k in self._spmd_batch_args:
                t = self._spmd_batch_whole(k, t)
            self.arg_dict[k]._data = t

    @staticmethod
    def _feed_csr(dst: CSRNDArray, v) -> None:
        """A batch into a csr argument: its arrays onto the argument's
        device (a dense batch is compressed first)."""
        if not isinstance(v, CSRNDArray):
            from .ndarray import sparse as _sparse

            v = _sparse.cast_storage(
                v if isinstance(v, NDArray) else NDArray(torch.as_tensor(v)),
                "csr")
        if tuple(v.shape) != tuple(dst.shape):
            raise MXNetError(f"forward: csr batch of shape {v.shape} for an "
                             f"argument bound as {dst.shape}")
        dev = dst.data_.device
        dst.data_ = v.data_.to(dev, dst.data_.dtype)
        dst.indices_ = v.indices_.to(dev)
        dst.indptr_ = v.indptr_.to(dev)

    def _spmd_batch_whole(self, name, t):
        """A batch argument fed as this rank's block (``shard_data_batch``)
        gathered whole: the bound buffers hold the global batch."""
        ndev = self._spmd_ndev()
        if ndev > 1 and t.dim() and t.shape[0] * ndev == self._spmd_batch:
            from .parallel.collectives import allgather

            with torch.no_grad():
                t = allgather(t, self._spmd_axis, axis=0,
                              mesh=self._spmd_mesh)
        return t

    def _env(self):
        """Variable name -> tensor; parameters stored as blocks gathered
        whole."""
        env = {n: self.arg_dict[n].csr_tensor() if n in self._csr_args
               else self.spmd_whole(n, self.arg_dict[n]._data)
               for n in self._arg_names}
        env.update((n, self.aux_dict[n]._data) for n in self._aux_names)
        return env

    def _run(self, is_train: bool, with_grad: bool, collect_aux: bool,
             rng=None):
        """Evaluate the graph: (outputs, aux updates, leaves); random
        nodes fold their uids into ``rng``."""
        env = self._env()
        leaves = {}
        if with_grad:
            for n in self._grad_arg_names:
                leaves[n] = env[n].detach().requires_grad_()
            env.update(leaves)
        aux_updates: Dict[str, torch.Tensor] = {}
        with torch.set_grad_enabled(with_grad):
            if self._grouped is not None:
                outs = self._grouped.trace(
                    env, is_train, aux_updates if collect_aux else None, rng)
            else:
                outs = trace(self._symbol._entries, env, is_train,
                             aux_updates if collect_aux else None,
                             self._order, self._release, rng,
                             resolve_device(self._ctx))
        return outs, aux_updates, leaves

    def _commit_aux(self, aux_updates) -> None:
        with torch.no_grad():
            for k, v in aux_updates.items():
                self.aux_dict[k]._data.copy_(v)

    def _set_outputs(self, outs) -> None:
        self._outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self._out_names, self._outputs):
                self._monitor_callback(name, out)

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        self._feed(kwargs)
        self._graph = None
        self._cached_grads = None
        with_grad = bool(is_train and self._grad_arg_names)
        # one key per forward, as the reference's; a backward that must
        # evaluate again reuses it
        self._last_rng = _random.next_key()
        outs, aux_updates, leaves = self._run(is_train, with_grad,
                                              collect_aux=is_train,
                                              rng=self._last_rng)
        if with_grad:
            self._graph = (outs, leaves)
        self._forwarded = True
        self._commit_aux(aux_updates)
        self._set_outputs(outs)
        return self._outputs

    def _grads(self, outs, leaves, out_cts) -> Dict[str, torch.Tensor]:
        pairs = [(o, c) for o, c in zip(outs, out_cts)
                 if o.requires_grad and o.is_floating_point()]
        names = list(leaves)
        if not pairs:
            return {n: torch.zeros_like(leaves[n]) for n in names}
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [leaves[n] for n in names],
                                  grad_outputs=[c for _, c in pairs],
                                  allow_unused=True)
        return {n: torch.zeros_like(leaves[n]) if g is None else g
                for n, g in zip(names, got)}

    def backward(self, out_grads=None, is_train: bool = True) -> None:
        """Write gradients into the bound grad arrays (``grad_req`` write
        or add)."""
        if out_grads is None:
            if self._cached_grads is None:
                if self._graph is None:
                    raise MXNetError(
                        "backward called before forward(is_train=True)")
                outs, leaves = self._graph
                self._graph = None
                self._cached_grads = self._grads(
                    outs, leaves, [_ones_cotangent(o) for o in outs])
            grads = self._cached_grads
        else:
            if not self._forwarded:
                raise MXNetError(
                    "backward called before forward(is_train=True)")
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            if self._graph is not None:
                outs, leaves = self._graph
                self._graph = None
            else:   # the graph went with an earlier backward: evaluate again
                outs, _, leaves = self._run(True, True, collect_aux=False,
                                            rng=self._last_rng)
            cts = [_as_tensor(g, o) for g, o in zip(out_grads, outs)]
            grads = self._grads(outs, leaves, cts)
        self._write_grads(grads)

    def _write_grads(self, grads) -> None:
        write, add = ([], []), ([], [])
        for n in self._grad_arg_names:
            dst = write if self.grad_req.get(n, "write") != "add" else add
            buf = self.grad_dict[n]._data
            dst[0].append(buf)
            dst[1].append(self.spmd_block(n, grads[n]).to(
                device=buf.device, dtype=buf.dtype))
        with torch.no_grad():
            if write[0]:
                torch._foreach_copy_(*write)
            if add[0]:
                torch._foreach_add_(*add)

    # -- fused whole-train-step ---------------------------------------------
    def fused_step(self, optimizer, states: Dict[str, object],
                   updates, feed: Optional[Dict[str, object]] = None,
                   num_steps: Optional[int] = None,
                   kvstore=None, loss_scaler=None) -> List[NDArray]:
        """Forward, backward and the optimizer's update of every
        gradient-taking argument, ``num_steps`` times over the same feed.

        ``updates`` is a list of ``(arg_name, optimizer_index)`` covering
        exactly the gradient-taking arguments; ``states`` maps each arg name
        to its optimizer state (``Optimizer.create_state_multi_precision``),
        updated in place.  The update counts advance as the per-parameter
        loop's do, and the rate is the scheduler's at each step.
        ``loss_scaler`` (an ``amp.LossScaler``) scales, checks and skips
        (module doc)."""
        if self._grouped is not None:
            raise MXNetError("fused_step does not support group2ctx "
                             "placement")
        unames = [n for n, _ in updates]
        if set(unames) != set(self._grad_arg_names):
            raise MXNetError(
                "fused_step: updates must cover exactly the gradient-taking "
                f"arguments {self._grad_arg_names}, got {sorted(unames)}")
        self._feed(feed)
        indices = [i for _, i in updates]
        counts = {optimizer._index_update_count.get(
            i, optimizer.begin_num_update) for i in indices}
        if len(counts) > 1:
            raise MXNetError(
                "fused_step: params carry mixed update counts; use the "
                "legacy per-param update path")
        mesh = self._spmd_mesh
        if mesh is not None:
            self._spmd_to_blocks(states)
        weights = [self.arg_dict[n] for n in unames]
        grads = [self.grad_dict[n] for n in unames]
        sts = [states[n] for n in unames]
        steps = max(1, int(num_steps or 1))
        from .observability import telemetry as _tele

        tele_on = _tele.enabled()
        rng = _random.next_key()
        for step in range(steps):
            self._graph = None
            srng = _random.fold(rng, step) if steps > 1 else rng
            sc = None if loss_scaler is None else loss_scaler.state(
                weights[0]._data.device if weights else None)
            if mesh is not None:
                outs, aux_updates, self._cached_grads = \
                    self._mesh_fwd_bwd(srng, None if sc is None else sc[0])
            else:
                outs, aux_updates, leaves = self._run(
                    True, True, collect_aux=True, rng=srng)
                self._cached_grads = self._grads(
                    outs, leaves, _seeds(outs, None if sc is None
                                         else sc[0]))
            self._step_nonfinite = None
            finite = sc is None or self._check_and_unscale(loss_scaler, sc)
            self._write_grads(self._cached_grads)
            if not finite:
                # overflow: the counts advance, nothing else is updated
                for i in indices:
                    optimizer._update_count(i)
                continue
            self._commit_aux(aux_updates)
            if optimizer.multi_tensor:
                optimizer.update_multi_precision_list(indices, weights,
                                                      grads, sts)
            else:
                for i, w, g, s in zip(indices, weights, grads, sts):
                    optimizer.update_multi_precision(i, w, g, s)
        self._forwarded = True
        if mesh is not None:
            outs = self._mesh_outputs(outs)
        if tele_on:
            with torch.no_grad():
                self._note_telemetry(self._step_telemetry(outs, loss_scaler))
        if mesh is not None:
            # the gradients are blocks: a later backward() recomputes
            self._cached_grads = None
        self._set_outputs(outs)
        return self._outputs

    def _check_and_unscale(self, scaler, sc) -> bool:
        """The loss-scaled step's check: the non-finite count of the
        (scaled, summed) gradients, summed over every mesh axis; the
        gradients unscaled in place; the scaler's state advanced on the
        device.  Returns the finite verdict (one host read)."""
        grads = self._cached_grads
        dev = sc[0].device
        # one pass over the gradients, this rank's blocks counted apart
        # for telemetry's sum over the axes they are cut on
        def is_block(n, g):
            return n in self._spmd_blocks and \
                tuple(g.shape) != self._spmd_blocks[n]

        rep = scaler.nonfinite_count([g for n, g in grads.items()
                                      if not is_block(n, g)])
        blk = scaler.nonfinite_count([g for n, g in grads.items()
                                      if is_block(n, g)])
        self._step_nonfinite = (rep, blk)
        nonfin = rep.to(dev) + blk.to(dev)
        mesh = self._spmd_mesh
        if mesh is not None and mesh.size > 1:
            from .parallel.collectives import psum_flat

            (nonfin,) = psum_flat([nonfin], tuple(mesh.axis_names), mesh)
        finite = nonfin == 0
        f32 = [g for g in grads.values() if g.dtype == torch.float32]
        with torch.no_grad():
            if f32:
                torch._foreach_div_(f32, sc[0])
            for n, g in grads.items():
                if g.is_floating_point() and g.dtype != torch.float32:
                    grads[n] = scaler.unscale(g, sc[0])
        scaler.set_state(scaler.next_state(sc, finite))
        return bool(finite)

    def _mesh_fwd_bwd(self, rng, scale=None):
        """One mesh step's forward and backward on this rank's block of the
        batch: (outputs, aux updates averaged over dp, gradients summed
        over dp in each parameter's stored layout).  ``scale`` seeds the
        floating outputs' cotangents (loss scaling)."""
        from .parallel.collectives import psum_flat, spmd

        mesh, axis = self._spmd_mesh, self._spmd_axis
        ndev, me = self._spmd_ndev(), mesh.axis_index(self._spmd_axis)
        tp = self._spmd_tp
        env = {}
        for n in self._arg_names:
            t = self.arg_dict[n]._data
            if n in self._spmd_batch_args:
                if t.shape[0] != self._spmd_batch:
                    raise MXNetError(
                        f"fused_step: batch dim of {n!r} "
                        f"({tuple(t.shape)}) is not the bound batch "
                        f"{self._spmd_batch} that the dp mesh size {ndev} "
                        f"divides")
                b = t.shape[0] // ndev
                t = t.narrow(0, me * b, b)
            elif n in self._spmd_blocks and (tp is None or n in tp.gathered):
                t = self.spmd_whole(n, t)
            env[n] = t
        env.update((n, self.aux_dict[n]._data) for n in self._aux_names)
        leaves = {n: env[n].detach().requires_grad_()
                  for n in self._grad_arg_names}
        env.update(leaves)
        aux_updates: Dict[str, torch.Tensor] = {}
        dev = resolve_device(self._ctx)
        if ndev > 1:
            # each dp rank's random nodes draw their own masks, as the
            # reference folds in its axis index (a world of one keeps the
            # plain step's key)
            rng = _random.fold(rng, me)
        with torch.enable_grad(), spmd(mesh):
            if self._spmd_pipeline is not None:
                plan, n_micro = self._spmd_pipeline
                outs = plan.apply(env, True, rng, aux_updates, n_micro,
                                  device=dev)
            elif tp is not None:
                outs = tp.trace(env, mesh, True, aux_updates, rng, dev)
            else:
                outs = trace(self._symbol._entries, env, True, aux_updates,
                             self._order, self._release, rng, dev)
            grads = self._grads(outs, leaves, _seeds(outs, scale))
        names = list(grads)
        if self._spmd_pipeline is not None:
            # prologue and stage gradients live on one pp rank each
            plan = self._spmd_pipeline[0]
            pp = [n for n in names if plan.pp_combine(n) == "psum"]
            for n, g in zip(pp, psum_flat([grads[n] for n in pp], "pp",
                                          mesh)):
                grads[n] = g
        # the sum over dp of the blocks' gradients: the global batch's
        for n, g in zip(names, psum_flat([grads[n] for n in names], axis,
                                         mesh)):
            grads[n] = g
        stats = [k for k, v in aux_updates.items() if v.is_floating_point()]
        for k, v in zip(stats, psum_flat([aux_updates[k] for k in stats],
                                         axis, mesh)):
            aux_updates[k] = v / ndev
        return outs, aux_updates, grads

    def _mesh_outputs(self, outs):
        """Outputs that carry the batch gathered whole over dp, the others
        averaged."""
        from .parallel.collectives import allgather, psum_flat

        mesh, axis, ndev = self._spmd_mesh, self._spmd_axis, \
            self._spmd_ndev()
        outs = [o.detach() for o in outs]
        rest = [i for i, ob in enumerate(self._spmd_out_is_batch)
                if not ob and outs[i].is_floating_point()]
        for i, v in zip(rest, psum_flat([outs[i] for i in rest], axis,
                                        mesh)):
            outs[i] = v / ndev
        with torch.no_grad():
            for i, ob in enumerate(self._spmd_out_is_batch):
                if ob:
                    outs[i] = allgather(outs[i], axis, axis=0, mesh=mesh)
        return outs

    # -- params & misc ------------------------------------------------------
    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False) -> None:
        for src, dst, what in ((arg_params, self.arg_dict, "argument"),
                               (aux_params, self.aux_dict, "aux state")):
            for k, v in (src or {}).items():
                if k in dst:
                    t = self.spmd_block(k, _as_tensor(v, dst[k]._data))
                    if t.shape != dst[k]._data.shape:
                        raise MXNetError(
                            f"copy_params_from: {what} {k!r} has shape "
                            f"{tuple(t.shape)}, bound as "
                            f"{tuple(dst[k]._data.shape)}")
                    with torch.no_grad():
                        dst[k]._data.copy_(t)
                elif not allow_extra_params:
                    raise MXNetError(f"copy_params_from: unknown {what} "
                                     f"{k!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Rebind with new input shapes, carrying over current params/aux
        (reference: Executor.reshape shares the bound arrays)."""
        new_exec = self._symbol.simple_bind(
            ctx=self._ctx, grad_req=self.grad_req,
            group2ctx=self._group2ctx, **kwargs)
        param_names = set(new_exec._arg_names) - set(kwargs)
        new_exec.copy_params_from(
            {n: self.arg_dict[n] for n in param_names
             if n in self.arg_dict
             and self.arg_dict[n].shape == new_exec.arg_dict[n].shape},
            {n: v for n, v in self.aux_dict.items()},
            allow_extra_params=True)
        return new_exec

    def set_monitor_callback(self, callback, monitor_all=False):
        self._monitor_callback = callback

    def debug_str(self) -> str:
        lines = [f"Symbol outputs: {self._out_names}"]
        for n in self._arg_names:
            lines.append(f"arg {n}: {self.arg_dict[n].shape}")
        return "\n".join(lines)
