"""All-to-all (Ulysses-style) sequence parallelism.

PyTorch counterpart of ``mxnet_tpu/parallel/sequence_parallel.py``.
Activations are sequence-sharded between attention calls; inside
attention one all-to-all re-shards q, k and v from sequence to heads
((B, T/n, H, D) -> (B, T, H/n, D)), each rank attends over the whole
sequence for its heads, and a second all-to-all shards the output back.
``impl="flash"`` runs the inner attention through
``ops.flash_attention.flash_attention`` (the forward, dQ and dK/dV CUDA
kernels on the card); ``impl="dense"`` through :func:`local_attention`.
The all-to-all returns contiguous (B, T, H/n, D) tensors, the layout the
flash wrappers take.
"""
from __future__ import annotations

import functools
from typing import Optional

from ..base import MXNetError
from .collectives import all_to_all, shard_map_compat
from .mesh import Mesh, PartitionSpec, get_mesh
from .ring_attention import local_attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                      impl: str = "dense"):
    """Call on each rank's (B, T/n, H, D) sequence blocks with
    ``axis_name`` bound; returns this rank's block of the output."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention as attn
    elif impl == "dense":
        attn = local_attention
    else:
        raise ValueError(f"unknown impl {impl!r}")

    def seq2head(x):
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    out = attn(seq2head(q), seq2head(k), seq2head(v), causal=causal)
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh: Optional[Mesh] = None,
                              axis_name: str = "sp", causal: bool = False,
                              impl: str = "dense"):
    """Host entry over whole q, k, v; checks up front that the mesh has
    the axis and that it divides the heads."""
    mesh = mesh or get_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        axes = sorted(mesh.axis_names) if mesh is not None else []
        raise MXNetError(
            f"ulysses_attention_sharded: axis {axis_name!r} is not in the "
            f"bound mesh (axes: {axes})")
    n = int(mesh.shape[axis_name])
    heads = q.shape[2]
    if heads % n:
        raise MXNetError(
            f"ulysses_attention_sharded: {heads} heads not divisible by "
            f"mesh axis {axis_name!r} of size {n}")
    spec = PartitionSpec(None, axis_name, None, None)
    fn = shard_map_compat(
        functools.partial(ulysses_attention, axis_name=axis_name,
                          causal=causal, impl=impl),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check=False)
    return fn(q, k, v)
