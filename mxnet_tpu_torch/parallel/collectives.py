"""Collectives over named mesh axes.

PyTorch counterpart of ``mxnet_tpu/parallel/collectives.py``.  Each rank
calls them on its own block, as code inside the reference's ``shard_map``
does; the axis name selects the process group (:class:`.mesh.Mesh`
``group``) of the mesh bound by :func:`spmd` (``shard_map_compat``), else
of the installed mesh.

Each collective is a ``torch.autograd.Function`` whose backward is the
transpose the reference's ``shard_map(check=False)`` takes: ``psum`` ->
``psum``, ``all_gather`` -> ``psum_scatter`` and back, ``all_to_all`` ->
the inverse ``all_to_all``, ``ppermute`` -> the inverse permutation.  So a
loss built from collectives differentiates as the reference's does, and
a train step that wants the gradient of a global mean sums the local
gradients itself, as ``make_sharded_train_step`` does.  For a consumer
replicated over the axis, :func:`psum_bcast` (psum, identity backward),
:func:`pcopy` (identity, psum backward) and :func:`allgather_bcast`
(all-gather, this rank's block of the cotangent) are tensor
parallelism's reduce, copy and gather and the pipeline's broadcast.
Autograd runs on each rank alone, so every rank must run the same
collectives' backwards in the same order: :func:`anchor` keeps a
collective result a rank discards in its graph.

``all_to_all`` runs one ``all_to_all_single`` over a contiguous buffer
(gloo has no list form) and ``ppermute`` one ``batch_isend_irecv`` (a ring
of blocking sends would deadlock).  A train step's gradients are summed
by :func:`psum_flat`: one collective per axis over one buffer of them
all, where a collective each would cost its host dispatch ~250 times a
step (the reference's XLA combines them the same way).
"""
from __future__ import annotations

import contextlib
import operator
import threading
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..base import MXNetError
from .mesh import Mesh, NamedSharding, PartitionSpec, gather, get_mesh, shard

__all__ = ["allreduce", "allgather", "reduce_scatter", "broadcast",
           "all_to_all", "ppermute", "psum_flat", "allreduce_tree",
           "allreduce_grads_spmd", "shard_map_compat", "spmd", "axis_size",
           "axis_index", "psum_bcast", "pcopy", "allgather_bcast", "anchor"]

_scope = threading.local()


@contextlib.contextmanager
def spmd(mesh: Mesh):
    """Bind ``mesh``'s axis names for the collectives called inside."""
    stack = _scope.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _mesh(axis_name, mesh=None) -> Mesh:
    if mesh is None:
        stack = getattr(_scope, "stack", None)
        mesh = stack[-1] if stack else get_mesh()
    if mesh is None:
        raise MXNetError(f"collective over axis {axis_name!r}: no mesh is "
                         f"bound (make_mesh, or spmd(mesh))")
    return mesh


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def axis_size(axis_name, mesh=None) -> int:
    """Size of a named axis (the product for a tuple of names)."""
    m = _mesh(axis_name, mesh)
    n = 1
    for a in _axes(axis_name):
        m._check_axis(a)
        n *= m.shape[a]
    return n


def axis_index(axis_name: str, mesh=None) -> int:
    """This rank's coordinate on a named axis."""
    return _mesh(axis_name, mesh).axis_index(axis_name)


def _global_ranks(group) -> List[int]:
    return dist.get_process_group_ranks(group)


# -- the primitives, each with its transpose ------------------------------------

def _psum(x, group):
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _gather_front(x, group, n):
    """All ranks' ``x`` concatenated along dim 0, in group order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 0)


def _scatter_front(x, group, n, me):
    """The sum over ranks of ``x``, this rank's 1/n of dim 0."""
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    return _psum(x, group).chunk(n, 0)[me].contiguous()


def _a2a(x, group, n, split_axis, concat_axis):
    """Chunk j of ``x`` along ``split_axis`` to rank j; the chunks received
    concatenated along ``concat_axis`` in rank order."""
    xs = x.movedim(split_axis, 0)
    if xs.shape[0] % n:
        raise MXNetError(f"all_to_all: dimension {split_axis} of size "
                         f"{xs.shape[0]} does not split {n} ways")
    xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:])).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shp = list(out.shape)
    shp[concat_axis:concat_axis + 2] = [shp[concat_axis]
                                        * shp[concat_axis + 1]]
    return out.reshape(shp).contiguous()


def _permute(x, group, me, perm):
    """``x`` sent along ``perm`` ((src, dst) pairs of axis coordinates);
    zeros where nothing arrives."""
    x = x.detach().contiguous()
    ranks = _global_ranks(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return x.clone()
    out = torch.zeros_like(x)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, x, ranks[dst[0]], group=group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _PsumBcast(torch.autograd.Function):
    """psum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pcopy(torch.autograd.Function):
    """Identity forward; backward: one psum of every cotangent, summed as
    one flat buffer (a single collective however many tensors, so every
    rank runs it once, in the same place of its backward)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(sh, dtype=dt, device=dv) if g is None else g
              for g, (sh, dt, dv) in zip(gs, ctx.meta)]
        flat = _psum(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        return (None, *(part.view(g.shape).to(g.dtype) for part, g in zip(
            flat.split([g.numel() for g in gs]), gs)))


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with ``extras`` tied into its graph: their
    cotangents are zeros.  Keeps a collective whose result this rank
    discards in its backward, so every rank runs the transpose."""

    @staticmethod
    def forward(ctx, out, *extras):
        ctx.meta = [(e.shape, e.dtype, e.device) for e in extras]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(sh, dtype=dt, device=dv)
                     for sh, dt, dv in ctx.meta))


class _GatherBcast(torch.autograd.Function):
    """All-gather forward; backward keeps this rank's block of the
    cotangent (no sum)."""

    @staticmethod
    def forward(ctx, x, group, n, me, axis):
        ctx.args = (me, axis, x.shape[axis])
        return _gather_front(x.movedim(axis, 0), group, n).movedim(
            0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        me, axis, b = ctx.args
        return g.narrow(axis, me * b, b), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, axis):
        ctx.args = (group, n, me, axis)
        return _gather_front(x.movedim(axis, 0), group, n).movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        group, n, me, axis = ctx.args
        return (_scatter_front(g.movedim(axis, 0), group, n, me)
                .movedim(0, axis), None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, axis):
        ctx.args = (group, n, me, axis)
        return _scatter_front(x.movedim(axis, 0), group, n, me) \
            .movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        group, n, me, axis = ctx.args
        return (_gather_front(g.movedim(axis, 0), group, n).movedim(0, axis),
                None, None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _a2a(g, group, n, concat_axis, split_axis), None, None, \
            None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, perm):
        ctx.args = (group, me, perm)
        return _permute(x, group, me, perm)

    @staticmethod
    def backward(ctx, g):
        group, me, perm = ctx.args
        return _permute(g, group, me, [(d, s) for s, d in perm]), None, \
            None, None


# -- the reference's surface ------------------------------------------------------

def allreduce(x, axis_name, mesh=None):
    """psum over the named axis (axes, for a tuple of names)."""
    m = _mesh(axis_name, mesh)
    for a in _axes(axis_name):
        x = _AllReduce.apply(x, m.group(a))
    return x


def allgather(x, axis_name: str, axis: int = 0, tiled: bool = True,
              mesh=None):
    """Every rank's ``x`` concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``."""
    m = _mesh(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, m.group(axis_name), m.shape[axis_name],
                            m.axis_index(axis_name), axis % x.dim())


def reduce_scatter(x, axis_name: str, axis: int = 0, mesh=None):
    """The sum over the axis, this rank's block of ``axis``."""
    m = _mesh(axis_name, mesh)
    n = m.shape[axis_name]
    if x.shape[axis] % n:
        raise MXNetError(f"reduce_scatter: dimension {axis} of size "
                         f"{x.shape[axis]} does not split {n} ways")
    return _ReduceScatter.apply(x, m.group(axis_name), n,
                                m.axis_index(axis_name), axis % x.dim())


def broadcast(x, axis_name: str, src: int = 0, mesh=None):
    """Rank ``src``'s ``x`` on every member of the axis: the reference's
    masked psum (its gradient is the psum of the cotangents, kept where
    ``src`` is).  An out-of-range ``src`` raises ``ValueError``: the mask
    would never fire and every rank would receive zeros."""
    n = axis_size(axis_name, mesh)
    src = operator.index(src)
    if not 0 <= src < n:
        raise ValueError(f"broadcast src={src} out of range for axis "
                         f"{axis_name!r} of size {n}")
    keep = torch.tensor(axis_index(axis_name, mesh) == src, device=x.device)
    return allreduce(torch.where(keep, x, torch.zeros_like(x)), axis_name,
                     mesh)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               mesh=None):
    """Tiled all-to-all: chunk j of ``split_axis`` to member j, the
    received chunks concatenated along ``concat_axis``."""
    m = _mesh(axis_name, mesh)
    return _AllToAll.apply(x, m.group(axis_name), m.shape[axis_name],
                           split_axis % x.dim(), concat_axis % x.dim())


def ppermute(x, axis_name: str, perm: Sequence, mesh=None):
    """``x`` sent along ``perm``, a list of (source, destination) axis
    coordinates; a member nothing is sent to gets zeros."""
    m = _mesh(axis_name, mesh)
    return _Permute.apply(x, m.group(axis_name), m.axis_index(axis_name),
                          [tuple(p) for p in perm])


def psum_bcast(x, axis_name, mesh=None):
    """psum over the named axis whose backward is the IDENTITY: replicates
    a value that only one member (or each member in part) holds, for a
    consumer that is replicated over the axis.  The row-parallel reduce of
    tensor parallelism and the pipeline's last-stage broadcast: every
    member's downstream cotangent is the same, so passing it through
    unsummed is exact (the reference's ``pipeline.psum_bcast``)."""
    m = _mesh(axis_name, mesh)
    for a in _axes(axis_name):
        x = _PsumBcast.apply(x, m.group(a))
    return x


def pcopy(x, axis_name, mesh=None):
    """Identity whose backward is a psum over the named axis: a replicated
    value entering computation that each member does on its own part (the
    column-parallel input of tensor parallelism), whose cotangents are
    partial and must be summed.  ``x`` may be a list or tuple of tensors:
    a tuple comes back, their cotangents summed by one collective."""
    m = _mesh(axis_name, mesh)
    many = isinstance(x, (list, tuple))
    xs = tuple(x) if many else (x,)
    for a in _axes(axis_name):
        xs = _Pcopy.apply(m.group(a), *xs)
    return xs if many else xs[0]


def anchor(out, extras):
    """``out``, with the tensors ``extras`` (results of collectives this
    rank does not use) tied into its graph with zero cotangents: a
    backward then runs their transposes on every rank, as SPMD needs."""
    extras = [e for e in extras if e.requires_grad]
    return _Anchor.apply(out, *extras) if extras else out


def allgather_bcast(x, axis_name: str, axis: int = 0, mesh=None):
    """Every member's block of ``x`` concatenated along ``axis`` for a
    replicated consumer: the backward keeps this member's block of the
    (replicated) cotangent, where :func:`allgather`'s sums the members'
    cotangents first."""
    m = _mesh(axis_name, mesh)
    return _GatherBcast.apply(x, m.group(axis_name), m.shape[axis_name],
                              m.axis_index(axis_name), axis % x.dim())


def psum_flat(tensors: Sequence[torch.Tensor], axis_name, mesh=None):
    """psum of every tensor over the named axis (axes), as one buffer per
    dtype: new tensors, not differentiable (a train step's gradients)."""
    m = _mesh(axis_name, mesh)
    out, by_dtype = [None] * len(tensors), {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        for a in _axes(axis_name):
            dist.all_reduce(flat, group=m.group(a))
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def allreduce_tree(values: List, mesh: Mesh = None, axis: str = "dp"):
    """Host-level allreduce of this rank's list of values (the reference
    passes every device's; each rank here holds its own): the local sum,
    summed over ``axis`` when a mesh with it is given or installed."""
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    mesh = mesh or get_mesh()
    if mesh is not None and axis in mesh.shape and mesh.shape[axis] > 1:
        acc = _psum(torch.as_tensor(acc).to(mesh.device), mesh.group(axis))
    return [acc] * len(values)


def allreduce_grads_spmd(grads: Dict[str, torch.Tensor], axis: str = "dp",
                         mesh=None):
    """pmean of every gradient over ``axis`` (one buffer)."""
    n = axis_size(axis, mesh)
    return {k: g / n for k, g in zip(grads, psum_flat(list(grads.values()),
                                                      axis, mesh))}


def _spec(s):
    if s is None:
        return PartitionSpec()
    return s if isinstance(s, PartitionSpec) else PartitionSpec(*s)


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs, check: bool = False):
    """The host-level form of an SPMD function: called with whole arrays,
    each rank runs ``f`` on its blocks (``in_specs``) with ``mesh``'s axes
    bound, and the outputs come back whole on every rank (all-gathered
    along the dimensions ``out_specs`` split).  ``check`` is accepted for
    the reference's signature."""
    multi_in = isinstance(in_specs, tuple) and not isinstance(
        in_specs, PartitionSpec)
    multi_out = isinstance(out_specs, tuple) and not isinstance(
        out_specs, PartitionSpec)

    def run(*args):
        specs = in_specs if multi_in else (in_specs,) * len(args)
        local = [shard(a, NamedSharding(mesh, _spec(s)))
                 for a, s in zip(args, specs)]
        with spmd(mesh):
            out = f(*local)
            outs = out if multi_out else (out,)
            ospecs = out_specs if multi_out else (out_specs,)
            whole = tuple(gather(o, NamedSharding(mesh, _spec(s)))
                          for o, s in zip(outs, ospecs))
        return whole if multi_out else whole[0]

    return run
