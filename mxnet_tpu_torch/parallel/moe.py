"""Expert parallelism: Switch-style top-1 MoE over an ``ep`` mesh axis.

PyTorch counterpart of ``mxnet_tpu/parallel/moe.py``.  Experts live one
per rank on the ``ep`` axis; tokens are dispatched with the
differentiable :func:`~.collectives.all_to_all`, processed by the local
expert and returned the same way.  Fixed capacity keeps every shape
static; tokens over capacity fall through with zero output (Switch
semantics).
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import (all_to_all, allgather_bcast, axis_index, axis_size,
                          pcopy, spmd)
from .mesh import get_mesh

__all__ = ["moe_dispatch_combine", "moe_apply_sharded", "top1_routing",
           "moe_partition_rules"]


def moe_partition_rules(axis_name: str = "ep"):
    """Expert placement as a rule set (``partition_rules``): expert
    parameter stacks (leading expert dim) shard dim 0 over the expert
    axis, the router replicates.  On a ("dp", "mp") mesh pass
    ``axis_name="mp"``."""
    return (
        (r"router", ()),                       # replicated gate
        (r"expert|w_in$|w_out$", (axis_name,)),  # one expert per shard
    )


def top1_routing(x, router_w, num_experts, capacity):
    """Top-1 router (Switch).  Returns (dispatch (E, C, B), combine (E, C,
    B)): dispatch places token b in expert e's slot c (0/1); combine is
    dispatch scaled by the softmax gate probability.  A token's position
    in its expert's queue is an int32 cumsum (a bf16 one collides slots
    above 256 tokens)."""
    probs = torch.softmax(x @ router_w, dim=-1)            # (B, E)
    gate, expert = probs.max(dim=-1)                       # (B,)
    onehot_i = torch.nn.functional.one_hot(expert, num_experts) \
        .to(torch.int32)                                   # (B, E)
    pos = (torch.cumsum(onehot_i, dim=0, dtype=torch.int32) * onehot_i
           - 1).float()
    kept = (pos < capacity) & (onehot_i > 0)
    pos_clip = pos.clamp(0, capacity - 1).long()
    slot = torch.nn.functional.one_hot(pos_clip, capacity).to(x.dtype)
    dispatch = torch.where(kept[..., None], slot,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    dispatch = dispatch.permute(1, 2, 0)                   # (E, C, B)
    combine = dispatch * gate[None, None, :]
    return dispatch, combine


def moe_dispatch_combine(x, router_w, expert_fn, expert_params,
                         axis_name: str = "ep", capacity_factor: float = 2.0):
    """Run on every rank of the axis (inside :func:`~.collectives.spmd`).
    ``x``: this rank's (B_local, D) tokens; one expert per rank.  Dispatch,
    all-to-all over ``axis_name``, the local expert, all-to-all back,
    combine.  Returns (B_local, D)."""
    n = axis_size(axis_name)
    B, D = x.shape
    capacity = max(1, int(B * capacity_factor / n))
    dispatch, combine = top1_routing(x, router_w, n, capacity)
    # this rank's tokens for every expert: (E, C, D); after the exchange
    # rank e holds the (C, D) blocks every source sent ITS expert, axis 0
    # the source
    expert_inputs = all_to_all(torch.einsum("ecb,bd->ecd", dispatch, x),
                               axis_name, 0, 0)
    processed = expert_fn(expert_params,
                          expert_inputs.reshape(n * capacity, D))
    processed = all_to_all(processed.reshape(n, capacity, -1), axis_name,
                           0, 0)
    return torch.einsum("ecb,ecd->bd", combine, processed)


def moe_apply_sharded(x, router_w, expert_params, expert_fn: Callable,
                      mesh=None, axis_name: str = "ep",
                      capacity_factor: float = 2.0):
    """Host entry: ``x`` (B, D), the router and the ``expert_params``
    (leading expert dim of size ``mesh.shape[axis_name]``; a tensor or a
    dict of tensors) whole on every rank.  Each rank routes its block of
    the batch with its own expert; the whole (B, D) output comes back on
    every rank, and gradients reach the whole inputs on every rank."""
    mesh = mesh or get_mesh()
    with spmd(mesh):
        me, n = axis_index(axis_name), axis_size(axis_name)
        # each rank's gradients of the whole inputs summed over the axis,
        # by one collective
        keys = list(expert_params) if isinstance(expert_params, dict) \
            else None
        leaves = [expert_params[k] for k in keys] if keys \
            else [expert_params]
        x, router_w, *leaves = pcopy([x, router_w, *leaves], axis_name)
        ep = {k: v[me] for k, v in zip(keys, leaves)} if keys \
            else leaves[0][me]
        b = x.shape[0] // n
        out = moe_dispatch_combine(x.narrow(0, me * b, b), router_w,
                                   expert_fn, ep, axis_name=axis_name,
                                   capacity_factor=capacity_factor)
        return allgather_bcast(out, axis_name, axis=0)
