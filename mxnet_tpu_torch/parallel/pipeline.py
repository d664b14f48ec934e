"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis.

PyTorch counterpart of ``mxnet_tpu/parallel/pipeline.py``.  Stages live on
the ``pp`` axis, one process each; microbatches flow stage to stage with
:func:`~.collectives.ppermute`, a steady-state bubble of (S-1)/(M+S-1).

The tick loop is plain Python over M + S - 1 ticks, and this rank's
coordinate is a Python int, so the reference's ``where(rank == ...)``
selects are branches; autograd differentiates the whole schedule (each
``ppermute``'s backward is the inverse permutation).  The gradient
contract is the reference's:

- the microbatch input is consumed only on stage 0, so its gradient —
  and every parameter upstream of it — is nonzero ONLY on stage 0:
  combine those with a psum over the pp axis;
- each stage's parameters are used only on their own rank: also psum;
- :func:`psum_bcast` replicates the last stage's committed outputs with
  an identity backward, so replicated consumers downstream see exact
  gradients with NO pp combination.

:func:`pipeline_apply_sharded` is the host entry: whole arrays in (the
stacked stage parameters and the microbatches, on every rank), whole
outputs back on every rank, and its gradients are the sequential stack's
on every rank (the inputs' per-rank gradients are summed over ``pp``).
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import (anchor, axis_index, axis_size, pcopy, ppermute,
                          psum_bcast, spmd)
from .mesh import get_mesh

__all__ = ["pipeline_apply", "pipeline_apply_sharded", "psum_bcast"]


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   axis_name: str = "pp"):
    """Run on every rank of the axis (inside :func:`~.collectives.spmd`).

    ``stage_fn(params, x) -> y``: one pipeline stage (same shape in and
    out); ``stage_params``: this rank's stage; ``x_microbatches``: (M, ...)
    microbatches, only stage 0's are read.  Returns (M, ...) outputs,
    valid on the LAST stage (zeros elsewhere): replicate them with
    :func:`psum_bcast`.  Each rank differentiates its own graph, so the
    activations a rank receives and does not use (stage 0's, and every
    stage's after the last tick) are tied to the outputs with zero
    cotangents: every rank's backward then runs each tick's inverse
    ``ppermute``, in the same order."""
    n = axis_size(axis_name)
    rank = axis_index(axis_name)
    M = x_microbatches.shape[0]
    state = torch.zeros_like(x_microbatches[0])
    outputs = [torch.zeros_like(x_microbatches[0]) for _ in range(M)]
    perm = [(j, (j + 1) % n) for j in range(n)]
    unused = []
    for t in range(M + n - 1):
        if rank == 0:
            # stage 0 ingests microbatch t (zeros past the last one)
            x = x_microbatches[min(t, M - 1)]
            if t:
                unused.append(state)
            state = x if t < M else x * 0.0
        y = stage_fn(stage_params, state)
        if t >= n - 1 and rank == n - 1:
            outputs[t - (n - 1)] = y   # the last stage commits
        state = ppermute(y, axis_name, perm)
    return anchor(torch.stack(outputs), unused + [state])


def pipeline_apply_sharded(stage_fn: Callable, stacked_params,
                           x_microbatches, mesh=None, axis_name: str = "pp"):
    """Host entry: ``stacked_params`` (a tensor or a dict of tensors) has
    a leading stage dim of size ``mesh.shape[axis_name]``; each rank takes
    its own stage's slice.  ``x_microbatches`` (M, B, ...) is the same on
    every rank.  Returns the (M, B, ...) outputs on every rank."""
    mesh = mesh or get_mesh()
    with spmd(mesh):
        me = axis_index(axis_name)
        # the per-rank gradients of the whole inputs (stage 0's of the
        # microbatches, each stage's of its slice) summed over pp, once
        keys = list(stacked_params) if isinstance(stacked_params, dict) \
            else None
        leaves = [stacked_params[k] for k in keys] if keys \
            else [stacked_params]
        *leaves, x = pcopy([*leaves, x_microbatches], axis_name)
        params = {k: v[me] for k, v in zip(keys, leaves)} if keys \
            else leaves[0][me]
        out = pipeline_apply(stage_fn, params, x, axis_name)
        return psum_bcast(out, axis_name)
