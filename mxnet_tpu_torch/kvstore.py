"""KVStore: parameter synchronization on one process.

PyTorch counterpart of the ``local`` and ``device`` stores of
``mxnet_tpu/kvstore.py`` (reference: ``include/mxnet/kvstore.h``,
``src/kvstore/kvstore_local.h``), with the reference's semantics:

- with an updater set (``set_optimizer``) the stored value is the weight:
  a push reduces the pushed gradients and applies the updater to it, a
  pull copies the weight out;
- without one, a push reduces and *replaces* the stored value, and a pull
  copies it out (the Trainer's path).

The store holds values, never references: the reference copies into an
immutable ``jax.Array``; a torch tensor is mutable, so the store copies
every value it keeps (``init``, a push's reduce) into tensors of its own,
and a pull copies into the destination's tensor in place.  Otherwise the
store would track the gradient buffer that the next backward overwrites.
A push or pull of a list of keys whose values are single tensors copies
them with one ``torch._foreach_copy_``.

Sparse values (``ndarray.sparse``) are kept sparse and by value too: a
reduce over row-sparse contributions concatenates them and
``compact()``s the sum, so the stored gradient holds one row a distinct
touched row; a pull of a sparse value into a dense destination writes
its dense value.  ``row_sparse_pull(key, out, row_ids)`` copies only the
rows ``row_ids`` (one id set per output, or one for all), zero
elsewhere.

``set_gradient_compression`` (``device`` store only, as in the
reference) quantizes and dequantizes every float32 contribution against
its error-feedback residual before the reduce
(``parallel.compression.GradientCompression``: the 2-bit pack and unpack
kernels on the card).

``tpu_sync`` (alias ``nccl``) is the ``device`` store of one process under
the reference's name for its collective store: no update runs on it
(``Module`` keeps the update off the store), and a Module may take the
fused train step over it (``_fused_step_ok``); with several devices the
``device`` and ``tpu_sync`` stores qualify for the mesh fused step
(``supports_spmd_fused``), whose gradient sum over ``dp`` is one
collective a dtype.  ``dist_sync``,
``dist_async`` and the ``dist_*_device`` names are the parameter server
between processes (``kvstore_dist.KVStoreDist``), as the reference maps
them.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .base import MXNetError
from .ndarray import sparse as _sparse
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "KVStoreTPUSync", "create"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _pairs(key, value):
    """``[(key, [values])]`` for one key or a list of keys, each with one
    value or a list of per-device values."""
    keys = _as_list(key)
    if not isinstance(key, (list, tuple)):
        return [(key, _as_list(value))]
    values = _as_list(value)
    if len(values) != len(keys):
        raise MXNetError(f"kvstore: {len(keys)} keys but {len(values)} "
                         f"values")
    return [(k, _as_list(v)) for k, v in zip(keys, values)]


def _same_slot(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


class KVStore:
    """The reference's KVStore API (abstract)."""

    def __init__(self):
        self._updater = None
        self._grad_compression = None
        self._type = "abstract"

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out=out, priority=priority)

    def set_optimizer(self, optimizer):
        from .optimizer import Updater

        self._updater = Updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression of pushed gradients (reference support
        matrix: device-reduce stores only, dense float32 gradients only;
        pulls stay full precision)."""
        if self._type == "local":
            raise MXNetError(
                "gradient compression is not supported for 'local' kvstore "
                "(reference supports 'device' and 'dist' types only)")
        from .parallel.compression import GradientCompression

        self._grad_compression = GradientCompression(**compression_params)
        self._residuals: Dict = {}

    def _set_updater(self, updater):
        self._updater = updater

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def _fused_step_ok(self) -> bool:
        """Whether a Module may skip this store's per-parameter push and
        pull for the fused train step: only a one-worker local-family
        store without compression, whose reduce of one contribution is a
        copy."""
        return False

    @property
    def supports_spmd_fused(self) -> bool:
        """Whether this store may act as the collective boundary of the
        mesh fused train step (reference: ``kvstore.supports_spmd_fused``):
        device-reduce stores (``device``, ``tpu_sync``) without
        compression; ``local`` and ``dist_*`` stores do not."""
        return False

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


class KVStoreLocal(KVStore):
    """The single-process store (``local``; ``device`` with
    ``device_reduce``); see the module doc."""

    def __init__(self, device_reduce: bool = False):
        super().__init__()
        self._type = "device" if device_reduce else "local"
        self._store: Dict = {}

    def _fused_step_ok(self) -> bool:
        return self._grad_compression is None and self.num_workers == 1

    @property
    def supports_spmd_fused(self) -> bool:
        return (self._type in ("device", "tpu_sync")
                and self._grad_compression is None
                and self.num_workers == 1)

    def init(self, key, value):
        for k, vs in _pairs(key, value):
            self._store[k] = self._copy_value(vs[0])

    @staticmethod
    def _copy_value(v):
        """``v`` by value (a sparse array stays sparse): callers reuse
        their gradient buffers every backward."""
        if isinstance(v, _sparse.RowSparseNDArray):
            return _sparse.RowSparseNDArray(v.values_.detach().clone(),
                                            v.indices_.clone(), v.shape)
        if isinstance(v, _sparse.CSRNDArray):
            return _sparse.CSRNDArray(v.data_.detach().clone(),
                                      v.indices_.clone(), v.indptr_.clone(),
                                      v.shape)
        return NDArray(v._data.detach().clone())

    def _compress(self, key, slot, data: torch.Tensor) -> torch.Tensor:
        """One contribution through the 2-bit round trip against its
        residual (reference: gradient_compression.h quantize with error
        feedback)."""
        if data.dtype != torch.float32:
            raise MXNetError("gradient compression supports fp32 only "
                             "(reference kvstore_dist_server.h:607)")
        dq, new_res = self._grad_compression.quantize_dequantize(
            data.contiguous(), self._residuals.get((key, slot)))
        self._residuals[(key, slot)] = new_res
        return dq

    def _compressing(self) -> bool:
        gc = self._grad_compression
        return gc is not None and gc.type != "none"

    def _reduce(self, vals: List[NDArray], key=None) -> NDArray:
        """The sum of the contributions (each compressed first), as an
        array of its own on the first one's device; row-sparse
        contributions sum row-sparse (concatenated, then compacted)."""
        if any(isinstance(v, _sparse.RowSparseNDArray) for v in vals):
            if len(vals) == 1:
                return self._copy_value(vals[0])
            dev = vals[0].values_.device
            return _sparse.RowSparseNDArray(
                torch.cat([v.values_.detach().to(dev) for v in vals]),
                torch.cat([v.indices_.to(dev) for v in vals]),
                vals[0].shape).compact()
        return NDArray(self._reduce_dense(vals, key))

    def _reduce_dense(self, vals: List[NDArray], key=None) -> torch.Tensor:
        datas = [v._data.detach() for v in vals]
        if self._compressing():
            datas = [self._compress(key, i, d) for i, d in enumerate(datas)]
        elif len(datas) == 1:
            return datas[0].clone()
        dev = datas[0].device
        out = datas[0]
        for d in datas[1:]:
            out = out + d.to(dev)
        return out

    def push(self, key, value, priority=0):
        pairs = _pairs(key, value)
        for k, _ in pairs:
            if k not in self._store:
                raise MXNetError(f"kvstore: key {k!r} not initialized")
        with torch.no_grad():
            if self._updater is None and not self._compressing() and all(
                    len(vs) == 1 and _dense(self._store[k], vs[0])
                    and _same_slot(self._store[k]._data, vs[0]._data)
                    for k, vs in pairs):
                torch._foreach_copy_([self._store[k]._data for k, _ in pairs],
                                     [vs[0]._data.detach() for _, vs in pairs])
                return
            for k, vs in pairs:
                merged = self._reduce(vs, key=k)
                if self._updater is not None:
                    self._updater(k, merged, self._store[k])
                else:
                    self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        dsts, srcs = [], []
        for k, outs in _pairs(key, out):
            src = self._store.get(k)
            if src is None:
                raise MXNetError(f"kvstore: key {k!r} not initialized")
            if not all(_dense(src, d) for d in outs):
                for dst in outs:
                    src.copyto(dst)
                continue
            for dst in outs:
                if dst._data.shape != src._data.shape:
                    raise MXNetError(
                        f"kvstore pull {k!r}: stored shape "
                        f"{tuple(src._data.shape)}, destination "
                        f"{tuple(dst._data.shape)}")
                dsts.append(dst._data)
                srcs.append(src._data)
        with torch.no_grad():
            if dsts:
                torch._foreach_copy_(dsts, srcs)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key (the rest zero): one
        id set per output, or one shared by all of a key's outputs
        (reference: ``kvstore.h`` PullRowSparse)."""
        keys = _as_list(key)
        outs, rids = _as_list(out), _as_list(row_ids)
        if len(keys) == 1:
            if not isinstance(out, (list, tuple)) or \
                    not isinstance(out[0], (list, tuple)):
                outs = [outs]
            rids = [rids]
        for k, o, r in zip(keys, outs, rids):
            src = self._store.get(k)
            if src is None:
                raise MXNetError(f"kvstore: key {k!r} not initialized")
            dsts, rlist = _as_list(o), _as_list(r)
            if len(rlist) == 1 and len(dsts) > 1:
                rlist = rlist * len(dsts)
            for dst, rid in zip(dsts, rlist):
                _sparse.retain(src, rid).copyto(dst)


def _dense(*arrays) -> bool:
    return not any(isinstance(a, _sparse.BaseSparseNDArray) for a in arrays)


class KVStoreTPUSync(KVStoreLocal):
    """``tpu_sync``: the reference's collective store, here on one
    process (see the module doc)."""

    def __init__(self):
        super().__init__(device_reduce=True)
        self._type = "tpu_sync"


def create(name: str = "local") -> KVStore:
    """``local``, ``device``, ``tpu_sync``/``nccl`` or ``dist_*``
    (reference: src/kvstore/kvstore.cc)."""
    name = name.lower()
    if name == "local" or name.startswith("local_"):
        return KVStoreLocal()
    if name == "device":
        return KVStoreLocal(device_reduce=True)
    if name in ("tpu_sync", "nccl"):
        return KVStoreTPUSync()
    if name.startswith("dist"):
        from .kvstore_dist import KVStoreDist

        return KVStoreDist(name)
    raise MXNetError(f"unknown kvstore type {name!r}")
