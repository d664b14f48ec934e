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

Not ported, each refused with ``MXNetError``: ``set_spmd`` and
``group2ctx`` placement (ROADMAP.md, Queue 1, item 5), loss scaling and
telemetry (Queue 1, item 6).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import random as _random
from .base import MXNetError
from .context import Context, resolve_device
from .ndarray.ndarray import NDArray
from .symbol.graph import release_plan, topo_order, trace

__all__ = ["Executor"]


def _ones_cotangent(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x)


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
        if group2ctx:
            raise MXNetError(
                "group2ctx placement is not ported (ROADMAP.md, Queue 1, "
                "item 5: multi-process distributed)")
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
        self._grad_arg_names = sorted(
            n for n in self._arg_names if self.grad_req.get(n, "null") != "null"
            and n in self.grad_dict)

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

    def set_spmd(self, mesh, batch_args, axis: str = "dp", **kwargs) -> None:
        if mesh is not None:
            raise MXNetError(
                "set_spmd: a data-parallel mesh is not ported (ROADMAP.md, "
                "Queue 1, item 5: multi-process distributed)")

    def telemetry_snapshot(self):
        raise MXNetError("executor telemetry is not ported (ROADMAP.md, "
                         "Queue 1, item 6: observability)")

    # -- evaluation ---------------------------------------------------------
    def _feed(self, feed) -> None:
        for k, v in (feed or {}).items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k!r}")
            self.arg_dict[k]._data = _as_tensor(v, self.arg_dict[k]._data)

    def _run(self, is_train: bool, with_grad: bool, collect_aux: bool,
             rng=None):
        """Evaluate the graph: (outputs, aux updates, leaves); random
        nodes fold their uids into ``rng``."""
        env = {n: self.arg_dict[n]._data for n in self._arg_names}
        env.update((n, self.aux_dict[n]._data) for n in self._aux_names)
        leaves = {}
        if with_grad:
            for n in self._grad_arg_names:
                leaves[n] = env[n].detach().requires_grad_()
            env.update(leaves)
        aux_updates: Dict[str, torch.Tensor] = {}
        with torch.set_grad_enabled(with_grad):
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
            dst[0].append(self.grad_dict[n]._data)
            dst[1].append(grads[n].to(self.grad_dict[n]._data.dtype))
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
        loop's do, and the rate is the scheduler's at each step."""
        if loss_scaler is not None:
            raise MXNetError("fused_step: loss scaling (AMP) is not ported "
                             "(ROADMAP.md, Queue 1, item 6)")
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
        weights = [self.arg_dict[n] for n in unames]
        grads = [self.grad_dict[n] for n in unames]
        sts = [states[n] for n in unames]
        steps = max(1, int(num_steps or 1))
        rng = _random.next_key()
        for step in range(steps):
            self._graph = None
            outs, aux_updates, leaves = self._run(
                True, True, collect_aux=True,
                rng=_random.fold(rng, step) if steps > 1 else rng)
            self._cached_grads = self._grads(
                outs, leaves, [_ones_cotangent(o) for o in outs])
            self._write_grads(self._cached_grads)
            self._commit_aux(aux_updates)
            if optimizer.multi_tensor:
                optimizer.update_multi_precision_list(indices, weights,
                                                      grads, sts)
            else:
                for i, w, g, s in zip(indices, weights, grads, sts):
                    optimizer.update_multi_precision(i, w, g, s)
        self._forwarded = True
        self._set_outputs(outs)
        return self._outputs

    # -- params & misc ------------------------------------------------------
    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False) -> None:
        for src, dst, what in ((arg_params, self.arg_dict, "argument"),
                               (aux_params, self.aux_dict, "aux state")):
            for k, v in (src or {}).items():
                if k in dst:
                    t = _as_tensor(v, dst[k]._data)
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
            ctx=self._ctx, grad_req=self.grad_req, **kwargs)
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
