"""Pipeline-stage discovery over the symbol DAG.

PyTorch counterpart of ``mxnet_tpu/symbol/staging.py``.  ``Module.fit``
gains a ``pp`` mesh axis (``TPUMX_PP_DEVICES``): the executor's mesh step
runs the repeated body of a stage-stackable symbol as a GPipe microbatch
round-robin over the ``pp`` ranks (``parallel/pipeline.py``), one process
per stage.

A symbol is *stage-stackable* when its op DAG contains a chain of ``S x k``
isomorphic units: same op sequence, same attrs, same parameter shapes,
same boundary activation shape and dtype (a deep MLP trunk, an unrolled
residual tower).  The plan splits the graph into:

- **prologue**: everything the pipeline input depends on, computed on every
  pp rank; its parameter gradients are nonzero only on stage 0 (only stage
  0 ingests the microbatches), so they combine with a psum over ``pp``;
- **body**: the repeated units, ``k`` per stage; stage ``s`` runs the
  TEMPLATE segment (stage 0's ops) with stage ``s``'s parameters.  Each
  rank's stage parameters get gradients on that rank only: psum over
  ``pp``;
- **epilogue**: everything downstream of the body, computed on every rank
  on the pipeline's outputs, replicated by ``psum_bcast``; its parameter
  gradients are exact on every rank (no combination).

Restrictions checked at plan time (the Module drops the ``pp`` axis with
the logged reason): the body carries no random ops and no aux states; no
parameter is shared between regions; prologue activations never skip past
the body.  Shapes come from the ops run on ``meta`` tensors
(:func:`node_output_structs`; the reference uses ``jax.eval_shape``): no
FLOPs and no device memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from .graph import (Node, SymbolEntry, _active_extra_inputs, eval_node,
                    topo_order)

__all__ = ["PipelinePlan", "PlanError", "plan_pipeline", "node_output_structs"]

_META = torch.device("meta")


class PlanError(MXNetError):
    """The symbol cannot be split into the requested pipeline stages; the
    message names the failed condition."""


def _meta(struct) -> torch.Tensor:
    dt = struct.dtype
    if not isinstance(dt, torch.dtype):
        dt = torch_dtype(_np.dtype(dt).name if not isinstance(dt, str)
                         else dt)
    return torch.empty(tuple(struct.shape), dtype=dt, device=_META)


def node_output_structs(entries: Sequence[SymbolEntry],
                        env_structs: Dict[str, object]) -> Dict[int, tuple]:
    """Abstractly evaluate the DAG: ``{id(node): (meta tensor, ...)}`` for
    every node (each carries ``shape`` and ``dtype``); ``env_structs``
    maps variable names to anything with ``shape`` and ``dtype``."""
    values: Dict[int, tuple] = {}
    with torch.no_grad():
        for node in topo_order(entries):
            if node.kind == "var":
                values[id(node)] = (_meta(env_structs[node.name]),)
                continue
            ins = [values[id(e.node)][e.index] for e in node.inputs]
            # shapes as in inference (a random op's key and the BatchNorm
            # kernels' wrapper need a real device), as shape inference runs
            values[id(node)] = eval_node(node, ins, False, device=_META)
    return values


def _sig_of(struct) -> tuple:
    return (tuple(struct.shape), str(struct.dtype))


@dataclass
class PipelinePlan:
    """The result of :func:`plan_pipeline`: the structure the executor's
    mesh step runs the pipelined forward from."""

    entries: Sequence[SymbolEntry]
    n_stages: int
    prologue_nodes: List[Node]
    body_nodes: List[Node]                 # all stages, execution order
    template_nodes: List[Node]             # stage 0's segment
    template_param_names: List[str]        # ordered var inputs of template
    stage_param_names: List[List[str]]     # per stage, aligned with template
    boundary: SymbolEntry                  # the body's input edge
    epilogue_nodes: List[Node]
    param_group: Dict[str, str] = field(default_factory=dict)
    units_per_stage: int = 1

    def pp_combine(self, name: str) -> str:
        """Gradient combination over the pp axis for parameter ``name``:
        ``"psum"`` (prologue and stage parameters) or ``"none"``
        (epilogue parameters, already exact and replicated)."""
        return "psum" if self.param_group.get(name) in ("prologue",
                                                        "stage") else "none"

    def describe(self) -> str:
        return (f"pp plan: {len(self.prologue_nodes)} prologue ops | "
                f"{self.n_stages} stages × {self.units_per_stage} units "
                f"({len(self.template_nodes)} ops/stage) | "
                f"{len(self.epilogue_nodes)} epilogue ops")

    def apply(self, env: Dict[str, torch.Tensor], is_train: bool, rng,
              collect_aux: Optional[dict], n_micro: int,
              axis_name: str = "pp", device=None):
        """``symbol.graph.trace`` over the whole entry list with the body
        run by :func:`~..parallel.pipeline.pipeline_apply` over
        ``n_micro`` microbatches; call on every rank of the axis, inside
        :func:`~..parallel.collectives.spmd`."""
        from ..parallel.collectives import axis_index
        from ..parallel.pipeline import pipeline_apply, psum_bcast

        values: Dict[int, tuple] = {}
        for node in topo_order(self.entries):
            if node.kind == "var":
                if node.name not in env:
                    raise ValueError(f"unbound variable {node.name!r}")
                values[id(node)] = (env[node.name],)

        def run(nodes, aux):
            for node in nodes:
                ins = [values[id(e.node)][e.index] for e in node.inputs]
                values[id(node)] = eval_node(node, ins, is_train, aux, rng,
                                             device)

        run(self.prologue_nodes, collect_aux)
        x = values[id(self.boundary.node)][self.boundary.index]
        B = x.shape[0]
        if B % n_micro:
            raise MXNetError(
                f"pipeline: local batch {B} not divisible by "
                f"{n_micro} microbatches")
        xmb = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
        # this rank's stage parameters under the template's names
        me = axis_index(axis_name)
        my_params = {t: env[self.stage_param_names[me][i]]
                     for i, t in enumerate(self.template_param_names)}
        template = self.template_nodes
        last = template[-1]

        def stage_fn(params, xin):
            vals: Dict[int, tuple] = {}
            for node in template:
                ins = []
                for e in node.inputs:
                    if e.node.kind == "var":
                        ins.append(params[e.node.name])
                    elif id(e.node) in vals:
                        ins.append(vals[id(e.node)][e.index])
                    else:
                        ins.append(xin)  # the stage's boundary input
                # the body has no aux states (plan_pipeline)
                vals[id(node)] = eval_node(node, ins, is_train, None, rng,
                                           device)
            return vals[id(last)][0]

        out = psum_bcast(pipeline_apply(stage_fn, my_params, xmb, axis_name),
                         axis_name)
        values[id(self.body_nodes[-1])] = (
            out.reshape((B,) + tuple(out.shape[2:])),)
        run(self.epilogue_nodes, collect_aux)
        return [values[id(e.node)][e.index] for e in self.entries]


def _consumers(entries) -> Dict[int, List[Tuple[Node, int]]]:
    out: Dict[int, List[Tuple[Node, int]]] = {}
    for node in topo_order(entries):
        for e in node.inputs:
            out.setdefault(id(e.node), []).append((node, e.index))
    return out


def _node_token(node: Node, structs, env_structs) -> tuple:
    attrs = tuple(sorted((k, str(v)) for k, v in node.attrs.items()))
    param_sig = tuple(_sig_of(env_structs[e.node.name])
                      for e in node.inputs if e.node.kind == "var")
    out_sig = tuple(_sig_of(s) for s in structs[id(node)])
    return (node.op.name, attrs, param_sig, out_sig)


def plan_pipeline(entries: Sequence[SymbolEntry], n_stages: int,
                  env_structs: Dict[str, object],
                  input_names: Sequence[str] = ()) -> PipelinePlan:
    """Split the symbol into ``n_stages`` isomorphic pipeline stages.

    ``env_structs`` maps every variable name to anything with ``shape`` and
    ``dtype`` at the BOUND shapes; ``input_names`` are the data, label and
    state variables (exempt from the parameter checks).  Raises
    :class:`PlanError` naming the failed condition when the graph is not
    stage-stackable."""
    n_stages = int(n_stages)
    if n_stages < 2:
        raise PlanError("pipeline needs n_stages >= 2")
    env_structs = {k: _meta(v) for k, v in env_structs.items()}
    order = topo_order(entries)
    op_nodes = [n for n in order if n.kind == "op"]
    if not op_nodes:
        raise PlanError("empty graph")
    consumers = _consumers(entries)
    inputs = set(input_names)
    out_node_ids = {id(e.node) for e in entries}
    structs = node_output_structs(entries, env_structs)

    def stageable(node: Node) -> bool:
        if node.op is None or getattr(node.op, "rng", False):
            return False  # stage uids would collide across ranks
        _, aux = _active_extra_inputs(node.op.name, node.attrs)
        if aux:
            return False  # running stats cannot commit from the tick loop
        op_ins = [e for e in node.inputs if e.node.kind == "op"]
        if len(op_ins) != 1 or node.num_outputs() != 1:
            return False
        for e in node.inputs:
            if e.node.kind == "var":
                if e.node.name in inputs:
                    return False  # the body must not read data or labels
                if len(consumers.get(id(e.node), [])) != 1:
                    return False  # a shared (tied) param spans stages
        return True

    # maximal single-consumer chains of stageable nodes
    def links_to(prev: Node, node: Node) -> bool:
        if id(prev) in out_node_ids:
            return False  # an exported activation pins the cut here
        cons = consumers.get(id(prev), [])
        return len(cons) == 1 and cons[0][0] is node

    runs: List[List[Node]] = []
    in_run: Dict[int, bool] = {}
    for node in op_nodes:
        if not stageable(node) or in_run.get(id(node)):
            continue
        run = [node]
        in_run[id(node)] = True
        while True:
            nxt = consumers.get(id(run[-1]), [])
            if len(nxt) != 1:
                break
            cand = nxt[0][0]
            if cand.kind != "op" or not stageable(cand) \
                    or not links_to(run[-1], cand) or in_run.get(id(cand)):
                break
            run.append(cand)
            in_run[id(cand)] = True
        runs.append(run)

    # the repeated unit covering the most ops S*k*u over all runs
    best = None  # (coverage, run, start, u, r_use)
    for run in runs:
        L = len(run)
        tokens = [_node_token(n, structs, env_structs) for n in run]

        def in_sig(idx: int) -> tuple:
            for e in run[idx].inputs:
                if e.node.kind == "op":
                    return _sig_of(structs[id(e.node)][e.index])
            e = run[idx].inputs[0]  # the data slot by op convention
            return _sig_of(env_structs[e.node.name])

        for u in range(1, L // n_stages + 1):
            for start in range(L - n_stages * u + 1):
                unit = tokens[start:start + u]
                r = 1
                while start + (r + 1) * u <= L and \
                        tokens[start + r * u:start + (r + 1) * u] == unit:
                    r += 1
                r_use = r - (r % n_stages)
                if r_use < n_stages:
                    continue
                # a ring: the unit's output is its input's shape and dtype
                out_sig = tokens[start][3]
                if len(out_sig) != 1 or out_sig[0] != in_sig(start) \
                        or tokens[start + u - 1][3][0] != in_sig(start):
                    continue
                coverage = r_use * u
                if best is None or coverage > best[0]:
                    # leading extra units stay in the prologue
                    best = (coverage, run, start + (r - r_use) * u, u, r_use)

    if best is None:
        raise PlanError(
            f"no chain of >= {n_stages} isomorphic units (same ops, attrs, "
            f"param shapes, and boundary activation) found")
    _, run, start, u, r_use = best
    k = r_use // n_stages
    body = run[start:start + r_use * u]
    body_ids = {id(n) for n in body}
    template = body[:k * u]
    boundary = next((e for e in body[0].inputs if e.node.kind == "op"),
                    body[0].inputs[0])

    # ancestors of the boundary: the prologue side of the cut
    anc_ids = set()
    stack = [boundary.node]
    while stack:
        n = stack.pop()
        if id(n) in anc_ids:
            continue
        anc_ids.add(id(n))
        stack.extend(e.node for e in n.inputs)
    # a prologue activation may feed only the prologue (and the boundary
    # the body's head): a skip edge past the body has no ring to ride
    for n in order:
        if n.kind != "op" or id(n) not in anc_ids:
            continue
        for c, _ in consumers.get(id(n), []):
            if id(c) in anc_ids:
                continue
            if n is boundary.node and c is body[0]:
                continue
            raise PlanError(
                f"prologue op {n.name!r} feeds past the pipeline boundary "
                f"into {c.name!r}")

    prologue = [n for n in order if n.kind == "op" and id(n) in anc_ids]
    epilogue = [n for n in order if n.kind == "op" and id(n) not in anc_ids
                and id(n) not in body_ids]

    # parameter grouping (gradient combination over pp)
    epi_ids = {id(n) for n in epilogue}
    param_group: Dict[str, str] = {}
    for n in order:
        if n.kind != "var" or n.name in inputs:
            continue
        where = set()
        for c, _ in consumers.get(id(n), []):
            if id(c) in body_ids:
                where.add("stage")
            elif id(c) in anc_ids:
                where.add("prologue")
            elif id(c) in epi_ids:
                where.add("epilogue")
        if len(where) > 1:
            raise PlanError(
                f"parameter {n.name!r} is shared across pipeline regions "
                f"({sorted(where)})")
        if where:
            param_group[n.name] = where.pop()

    template_param_names = [e.node.name for node in template
                            for e in node.inputs if e.node.kind == "var"]
    stage_param_names = []
    for s in range(n_stages):
        seg = body[s * k * u:(s + 1) * k * u]
        stage_param_names.append(
            [e.node.name for node in seg
             for e in node.inputs if e.node.kind == "var"])

    return PipelinePlan(
        entries=entries, n_stages=n_stages, prologue_nodes=prologue,
        body_nodes=body, template_nodes=template,
        template_param_names=template_param_names,
        stage_param_names=stage_param_names, boundary=boundary,
        epilogue_nodes=epilogue, param_group=param_group,
        units_per_stage=k)
