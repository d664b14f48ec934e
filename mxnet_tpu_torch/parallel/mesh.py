"""Device meshes over the ranks of a ``torch.distributed`` world.

PyTorch counterpart of ``mxnet_tpu/parallel/mesh.py``.  The reference runs
SPMD in one process over N devices; the port runs one process per device,
in PyTorch's idiom: a mesh's devices are the ranks of the default process
group, laid out row-major over the named axes, with one sub-group per axis
(``torch.distributed.device_mesh.init_device_mesh``).  Each rank holds its
own block of a sharded array and the whole of a replicated one.

:func:`make_mesh` starts the default process group when none exists:

- from ``tools/launch.py``'s ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_PROCS`` /
  ``MXTPU_PROC_ID``, rendezvousing on the first port above the dist
  kvstore's server tier (which listens on the coordinator's port and the
  ``MXTPU_NUM_SERVERS - 1`` after it);
- or from torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``;
- or, with neither set, as a world of one process.

The backend is NCCL, each rank on ``cuda:<local rank>``, unless the caller
asks for the CPU (``device="cpu"`` or ``with mx.cpu():``); then it is
gloo.  A mesh whose size is not the world's, and an NCCL world with more
ranks on a host than visible CUDA devices, raise ``MXNetError`` before
NCCL is reached.

:func:`sharding_for` returns a :class:`NamedSharding` record (the mesh
and a :class:`PartitionSpec`) that :func:`shard` and :func:`gather` read:
``shard`` cuts this rank's block of a host array, ``gather`` all-gathers
the blocks back into the whole array on every rank.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["MeshConfig", "Mesh", "PartitionSpec", "NamedSharding",
           "make_mesh", "get_mesh", "set_mesh", "local_mesh", "dp_mesh",
           "sharding_for", "shard", "gather", "shutdown"]

_current_mesh: Optional["Mesh"] = None
_meshes: Dict[tuple, "Mesh"] = {}


@dataclass
class MeshConfig:
    """Named mesh axes; standard names: dp (data), tp (tensor/model),
    pp (pipeline), sp (sequence), ep (expert)."""

    axes: Dict[str, int] = field(default_factory=dict)

    @property
    def size(self):
        return math.prod(self.axes.values())


class PartitionSpec(tuple):
    """One entry per array dimension: an axis name, a tuple of axis names
    (the dimension split over their product, the first one major), or
    ``None`` (not split)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """This rank's view of a named mesh over the world: ``axis_names``,
    ``shape`` (axis -> size), ``device`` (this rank's), the process group
    of each axis (:meth:`group`) and this rank's coordinate on it
    (:meth:`axis_index`)."""

    def __init__(self, device_mesh, axes: Dict[str, int],
                 device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(axes)
        self.size = math.prod(axes.values())
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        coords = np.unravel_index(self.rank, tuple(axes.values())) \
            if axes else ()
        self._coords = {a: int(c) for a, c in zip(self.axis_names, coords)}

    def group(self, axis: str):
        """The process group of ``axis`` (this rank's row along it)."""
        self._check_axis(axis)
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        self._check_axis(axis)
        return self._coords[axis]

    def _check_axis(self, axis):
        if axis not in self.shape:
            raise MXNetError(f"axis {axis!r} is not in the mesh (axes: "
                             f"{list(self.axis_names)})")

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device},"
                f" backend={self.backend!r})")


def _env_int(name) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _rendezvous():
    """``(init_method, world_size, rank, local_rank, local_world)`` from the
    launcher's or torchrun's variables; ``(None, 1, 0, 0, 1)`` without."""
    coord = os.environ.get("MXTPU_COORDINATOR")
    if coord and _env_int("MXTPU_NUM_PROCS") is not None:
        world = _env_int("MXTPU_NUM_PROCS")
        rank = _env_int("MXTPU_PROC_ID") or 0
        host, _, port = coord.rpartition(":")
        # the dist kvstore's servers hold the coordinator's port and the
        # ones after it; the process group takes the next
        servers = max(1, _env_int("MXTPU_NUM_SERVERS") or 1)
        init = f"tcp://{host}:{int(port) + servers}"
        local = _env_int("LOCAL_RANK")
        return init, world, rank, rank if local is None else local, \
            _env_int("LOCAL_WORLD_SIZE") or world
    if _env_int("WORLD_SIZE") is not None and os.environ.get("MASTER_ADDR"):
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK") or 0
        local = _env_int("LOCAL_RANK")
        return "env://", world, rank, rank if local is None else local, \
            _env_int("LOCAL_WORLD_SIZE") or world
    return None, 1, 0, 0, 1


def _mesh_device(device) -> torch.device:
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        device = device.torch_device
    return torch.device(device)


def _init_world(cuda: bool):
    """Start the default process group (see the module doc); returns this
    rank's local rank."""
    init, world, rank, local, local_world = _rendezvous()
    backend = "nccl" if cuda else "gloo"
    if cuda:
        ndev = torch.cuda.device_count()
        if local_world > ndev or local >= ndev:
            raise MXNetError(
                f"make_mesh: {local_world} NCCL ranks on this host but "
                f"{ndev} visible CUDA device(s): NCCL refuses two ranks on "
                f"one device; launch at most {ndev} processes a host, or "
                f"ask for the CPU (device=\"cpu\") to run over gloo")
        torch.cuda.set_device(local)
    if init is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    return local


def make_mesh(axes: Dict[str, int] = None, devices=None, install: bool = True,
              device=None, **axis_kwargs) -> Mesh:
    """The mesh ``make_mesh({'dp': 2, 'sp': 2})`` or ``make_mesh(dp=2,
    sp=2)`` over the world, starting the world first if need be (module
    doc).  ``install=False`` leaves the ambient :func:`get_mesh` as it
    was.  ``device``: this rank's device (default: the current context,
    ``gpu(0)`` unless ``with mx.cpu():``); a CUDA device means NCCL, the
    CPU gloo.  ``devices`` is accepted for the reference's signature: the
    world's ranks are the devices.  Meshes are cached by axes and backend,
    so every call with the same axes returns the same process groups."""
    axes = dict(axes or {})
    axes.update(axis_kwargs)
    axes = {str(k): int(v) for k, v in axes.items()}
    dev = _mesh_device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise MXNetError("make_mesh: CUDA is not available; pass "
                         "device=\"cpu\" (or use `with mx.cpu():`) for a "
                         "gloo world")
    size = math.prod(axes.values())
    if not dist.is_initialized():
        # a mesh the world to be started cannot hold raises before it
        # starts (no process group is left behind)
        world = _rendezvous()[1]
        if size != world:
            raise MXNetError(f"make_mesh: mesh {axes} has {size} devices but"
                             f" the world has {world} processes")
        local = _init_world(cuda)
    else:
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = dist.get_rank() % max(1, torch.cuda.device_count()) \
                if cuda else 0
    backend = dist.get_backend()
    if (backend == "nccl") != cuda:
        raise MXNetError(
            f"make_mesh: the world runs {backend!r} but this mesh asks for "
            f"{'cuda' if cuda else 'the cpu'}; one process group serves "
            f"one device type")
    world = dist.get_world_size()
    if size != world:
        raise MXNetError(f"make_mesh: mesh {axes} has {size} devices but the"
                         f" world has {world} processes")
    key = (tuple(axes.items()), backend)
    mesh = _meshes.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh

        rank_dev = torch.device("cuda", local) if cuda else dev
        dm = init_device_mesh("cuda" if cuda else "cpu",
                              tuple(axes.values()),
                              mesh_dim_names=tuple(axes)) if axes else None
        mesh = _meshes[key] = Mesh(dm, axes, rank_dev, backend)
    if install:
        set_mesh(mesh)
    return mesh


def dp_mesh(ndev: int, devices=None, axis_name: str = "dp",
            device=None) -> Mesh:
    """One-axis data-parallel mesh of ``ndev`` ranks, not installed."""
    return make_mesh({axis_name: int(ndev)}, devices=devices, install=False,
                     device=device)


def local_mesh(axis_name: str = "dp", device=None) -> Mesh:
    """One-axis mesh over the whole world, installed."""
    size = dist.get_world_size() if dist.is_initialized() \
        else _rendezvous()[1]
    return make_mesh({axis_name: size}, device=device)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def shutdown() -> None:
    """Forget every mesh and destroy the default process group (and with
    it the axes' sub-groups)."""
    global _current_mesh
    _current_mesh = None
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: how a whole array is cut into
    the ranks' blocks."""

    mesh: Mesh
    spec: PartitionSpec


def sharding_for(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def _dim_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _block(mesh: Mesh, axes) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dimension split over
    ``axes`` (row-major, the first axis major)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return idx, n


def shard(x, sharding: NamedSharding):
    """This rank's block of the whole array ``x`` (numpy or tensor) under
    ``sharding``; a tensor on the mesh's device."""
    mesh = sharding.mesh
    t = torch.as_tensor(np.ascontiguousarray(x)
                        if isinstance(x, np.ndarray) else x)
    for d, part in enumerate(sharding.spec):
        axes = _dim_axes(part)
        if not axes:
            continue
        idx, n = _block(mesh, axes)
        if t.shape[d] % n:
            raise MXNetError(f"shard: dimension {d} of size {t.shape[d]} "
                             f"does not split over {axes} ({n} blocks)")
        b = t.shape[d] // n
        t = t.narrow(d, idx * b, b)
    return t.contiguous().to(mesh.device)


def gather(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole array from each rank's block ``t`` under ``sharding``
    (an all-gather along every split dimension; differentiable)."""
    from .collectives import allgather

    mesh = sharding.mesh
    for d, part in enumerate(sharding.spec):
        # the minor axis first: each gather concatenates whole blocks of
        # the axes after it
        for a in reversed(_dim_axes(part)):
            t = allgather(t, a, axis=d, tiled=True, mesh=mesh)
    return t
