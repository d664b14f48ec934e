"""Sparse NDArrays: ``row_sparse`` and ``csr``.

PyTorch counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
``include/mxnet/ndarray.h`` kRowSparseStorage/kCSRStorage,
``src/operator/tensor/cast_storage*``, the sparse paths of ``dot.cc``).

A :class:`RowSparseNDArray` holds ``values_`` (K, *cols) and
``indices_`` (K,) int32 padded with -1 for unused slots; a
:class:`CSRNDArray` holds ``data_`` (nnz,), ``indices_`` (nnz,) and
``indptr_`` (rows + 1,) int32.  Both live on one device (the constructor's
``ctx``, the current context by default) and are handles of the port's
NDArray: ``_data`` is the dense value, made when it is read (the
reference's lazy materialization), so every dense op takes a sparse
array.  The reference's semantics, kept here:

- ``indices`` and ``data`` drop the padded slots; ``compact()`` merges
  duplicate rows into sorted unique ones, so an eager sum of row-sparse
  arrays (``elemwise_add``, the kvstore's reduce) holds one slot a
  distinct row however many arrays it adds;
- writing a dense value into a row-sparse array (``_data = v``, ``[:]``,
  ``copyto``, an optimizer update) makes its pattern the value's non-zero
  rows, so rows outside the old pattern are kept, not dropped;
- ``csr[a:b]`` is a CSR array, ``csr[i]`` a dense row; data from a scipy
  matrix is float32.

``dot`` with a csr left operand computes from the stored values
(:func:`ops.spatial.csr_dot`: a gather and a per-row segment sum), where
the reference densifies first: the same numbers, summed in another
order.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import context_of
from ..ops.spatial import CsrTensor, csr_dot
from .ndarray import NDArray, _device

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "cast_storage",
           "retain", "dot", "add", "elemwise_add", "sparse_retain"]


class BaseSparseNDArray(NDArray):
    """A sparse handle: the dense value is ``_data``, made on each read."""

    __slots__ = ()

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def ndim(self):
        return len(self.shape)

    def tostype(self, stype):
        return cast_storage(self, stype)

    def asnumpy(self) -> _np.ndarray:
        return self._data.detach().to("cpu").numpy()

    def _write(self, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self._data = torch.broadcast_to(
            value.to(self.context_device, self.dtype_torch),
            self.shape).clone()

    def __setitem__(self, key, value):
        dense = self._data
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(_np.asarray(value), dtype=dense.dtype)
        dense[self._convert_key(key)] = value
        self._data = dense

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError("attach_grad on a sparse array: cast it with "
                         "tostype(\"default\") first")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse: the full shape, non-zero only in the rows ``indices_``
    holds."""

    __slots__ = ("values_", "indices_", "_shape_full")

    def __init__(self, values, indices, shape):
        self.values_ = values
        self.indices_ = indices
        self._shape_full = tuple(shape)
        super().__init__(None)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def _data(self):
        return self._to_dense()

    @_data.setter
    def _data(self, v):
        if v is None:
            return
        # the pattern is the written value's non-zero rows
        flat = v.detach().reshape(v.shape[0], -1)
        nz = torch.nonzero(flat.ne(0).any(dim=1)).reshape(-1)
        self.indices_ = nz.to(torch.int32)
        self.values_ = v.detach().index_select(0, nz)

    @property
    def context_device(self):
        return self.values_.device

    @property
    def dtype_torch(self):
        return self.values_.dtype

    def compact(self):
        """Merge duplicate indices and drop the unused (-1) slots in place:
        sorted unique indices, one slot a distinct row."""
        valid = torch.nonzero(self.indices_ >= 0).reshape(-1)
        uniq, inv = torch.unique(self.indices_.index_select(0, valid),
                                 sorted=True, return_inverse=True)
        out = torch.zeros((uniq.shape[0],) + tuple(self.values_.shape[1:]),
                          dtype=self.values_.dtype,
                          device=self.values_.device)
        out.index_add_(0, inv, self.values_.index_select(0, valid))
        self.values_ = out
        self.indices_ = uniq.to(torch.int32)
        return self

    def _to_dense(self) -> torch.Tensor:
        out = torch.zeros(self._shape_full, dtype=self.values_.dtype,
                          device=self.values_.device)
        valid = self.indices_ >= 0
        idx = torch.where(valid, self.indices_, 0).long()
        vals = torch.where(
            valid.reshape((-1,) + (1,) * (self.values_.ndim - 1)),
            self.values_, torch.zeros((), dtype=self.values_.dtype,
                                      device=self.values_.device))
        return out.index_add_(0, idx, vals)

    @property
    def shape(self):
        return self._shape_full

    @property
    def dtype(self):
        return np_dtype(self.values_.dtype)

    @property
    def context(self):
        return context_of(self.values_.device)

    ctx = context

    @property
    def indices(self) -> NDArray:
        valid = self.indices_ >= 0
        return NDArray(self.indices_[valid].to(torch.int32))

    @property
    def data(self) -> NDArray:
        valid = self.indices_ >= 0
        return NDArray(self.values_[valid].clone())

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            dev = other.values_.device
            other.values_ = self.values_.to(dev, copy=True)
            other.indices_ = self.indices_.to(dev, copy=True)
            other._shape_full = self._shape_full
            return other
        if isinstance(other, NDArray):
            other._write(self._data)
            return other
        dev = _device(other)
        return RowSparseNDArray(self.values_.to(dev, copy=True),
                                self.indices_.to(dev, copy=True),
                                self._shape_full)

    def wait_to_read(self):
        if self.values_.is_cuda:
            torch.cuda.synchronize(self.values_.device)
        return self

    def __repr__(self):
        n = int((self.indices_ >= 0).sum())
        return (f"\n<RowSparseNDArray {'x'.join(map(str, self.shape))} "
                f"nnz-rows={n} @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows of a 2-d array."""

    __slots__ = ("data_", "indices_", "indptr_", "_shape_full")

    def __init__(self, data, indices, indptr, shape):
        self.data_ = data
        self.indices_ = indices
        self.indptr_ = indptr
        self._shape_full = tuple(shape)
        super().__init__(None)

    @property
    def stype(self):
        return "csr"

    @property
    def _data(self):
        return self.csr_tensor().dense()

    @_data.setter
    def _data(self, v):
        if v is None:
            return
        d = _from_dense_csr(v.detach())
        self.data_, self.indices_, self.indptr_ = d.data_, d.indices_, \
            d.indptr_

    @property
    def context_device(self):
        return self.data_.device

    @property
    def dtype_torch(self):
        return self.data_.dtype

    def csr_tensor(self) -> CsrTensor:
        """The arrays as one graph value (``ops.spatial.CsrTensor``)."""
        return CsrTensor.make(self.data_, self.indices_, self.indptr_,
                              self._shape_full)

    @property
    def shape(self):
        return self._shape_full

    @property
    def dtype(self):
        return np_dtype(self.data_.dtype)

    @property
    def context(self):
        return context_of(self.data_.device)

    ctx = context

    @property
    def data(self) -> NDArray:
        return NDArray(self.data_.clone())

    @property
    def indices(self) -> NDArray:
        return NDArray(self.indices_.to(torch.int32, copy=True))

    @property
    def indptr(self) -> NDArray:
        return NDArray(self.indptr_.to(torch.int32, copy=True))

    def copyto(self, other):
        if isinstance(other, CSRNDArray):
            dev = other.data_.device
            other.data_ = self.data_.to(dev, copy=True)
            other.indices_ = self.indices_.to(dev, copy=True)
            other.indptr_ = self.indptr_.to(dev, copy=True)
            other._shape_full = self._shape_full
            return other
        if isinstance(other, NDArray):
            other._write(self._data)
            return other
        dev = _device(other)
        return CSRNDArray(self.data_.to(dev, copy=True),
                          self.indices_.to(dev, copy=True),
                          self.indptr_.to(dev, copy=True), self._shape_full)

    def wait_to_read(self):
        if self.data_.is_cuda:
            torch.cuda.synchronize(self.data_.device)
        return self

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._shape_full[0])
            if step == 1:
                return _csr_rows(self, start, max(start, stop))
            return _from_dense_csr(self._data[key])
        return NDArray(self._data[key])

    def __repr__(self):
        return (f"\n<CSRNDArray {'x'.join(map(str, self.shape))} "
                f"nnz={self.data_.shape[0]} @{self.context}>")


def _csr_rows(a: CSRNDArray, start: int, stop: int) -> CSRNDArray:
    """Rows ``start:stop`` of a CSR array (its stored values kept)."""
    ptr = a.indptr_.detach().to("cpu")
    lo, hi = int(ptr[start]), int(ptr[stop])
    return CSRNDArray(a.data_[lo:hi].clone(), a.indices_[lo:hi].clone(),
                      (a.indptr_[start:stop + 1] - lo).clone(),
                      (stop - start, a._shape_full[1]))


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _host(x, dtype):
    if isinstance(x, NDArray):
        x = x.asnumpy()
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return _np.asarray(x, dtype=dtype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``(values, indices)`` with an optional full ``shape``, or a dense
    array (its non-zero rows kept), on ``ctx``."""
    dev = _device(ctx)
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 and \
            not _np.isscalar(arg1[0]):
        values = _host(arg1[0], np_dtype(dtype) if dtype else _np.float32)
        indices = _host(arg1[1], _np.int32)
        if shape is None:
            nrows = int(indices.max()) + 1 if indices.size else 0
            shape = (nrows,) + values.shape[1:]
        return RowSparseNDArray(torch.from_numpy(values).to(dev),
                                torch.from_numpy(indices).to(dev), shape)
    if isinstance(arg1, NDArray):
        dense = arg1._data.detach().to(dev)
        if dtype is not None:
            dense = dense.to(torch_dtype(dtype))
    else:
        dense = torch.from_numpy(_np.array(
            arg1, dtype=np_dtype(dtype) if dtype else None)).to(dev)
    return _from_dense_rsp(dense)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``(data, indices, indptr)`` with an optional ``shape``, a scipy
    sparse matrix (its data as float32), or a dense array, on ``ctx``."""
    dev = _device(ctx)
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data = _host(arg1[0], np_dtype(dtype) if dtype else _np.float32)
        indices = _host(arg1[1], _np.int32)
        indptr = _host(arg1[2], _np.int32)
        if shape is None:
            shape = (len(indptr) - 1,
                     int(indices.max()) + 1 if indices.size else 0)
        return CSRNDArray(torch.from_numpy(data).to(dev),
                          torch.from_numpy(indices).to(dev),
                          torch.from_numpy(indptr).to(dev), shape)
    if hasattr(arg1, "tocsr"):   # a scipy matrix
        m = arg1.tocsr()
        return CSRNDArray(
            torch.from_numpy(m.data.astype(_np.float32)).to(dev),
            torch.from_numpy(m.indices.astype(_np.int32)).to(dev),
            torch.from_numpy(m.indptr.astype(_np.int32)).to(dev), m.shape)
    if isinstance(arg1, NDArray):
        dense = arg1._data.detach().to(dev, torch_dtype(dtype or "float32"))
    else:
        dense = torch.from_numpy(_np.array(
            arg1, dtype=np_dtype(dtype) if dtype else _np.float32)).to(dev)
    return _from_dense_csr(dense)


def _from_dense_rsp(dense: torch.Tensor) -> RowSparseNDArray:
    out = RowSparseNDArray(None, None, tuple(dense.shape))
    out._data = dense
    return out


def _from_dense_csr(dense: torch.Tensor) -> CSRNDArray:
    rows, cols = torch.nonzero(dense, as_tuple=True)
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int32,
                         device=dense.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSRNDArray(dense[rows, cols], cols.to(torch.int32), indptr,
                      tuple(dense.shape))


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of storage type ``stype`` on ``ctx``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev, dt = _device(ctx), torch_dtype(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise ValueError(f"unknown stype {stype}")


# ---------------------------------------------------------------------------
# storage casts and the sparse functions
# ---------------------------------------------------------------------------

def cast_storage(arr, stype):
    """``arr`` in storage type ``stype`` (itself when it has it already;
    reference: cast_storage.cc)."""
    if stype == arr.stype:
        return arr
    dense = arr._data
    if stype == "default":
        return NDArray(dense.detach().clone()
                       if not isinstance(arr, BaseSparseNDArray) else dense)
    if stype == "row_sparse":
        return _from_dense_rsp(dense.detach())
    if stype == "csr":
        return _from_dense_csr(dense.detach())
    raise ValueError(f"unknown stype {stype}")


def retain(arr, indices):
    """The rows ``indices`` of a row-sparse (or dense) array, as a
    row-sparse array (reference: ``_retain``)."""
    if isinstance(indices, NDArray):
        want = indices._data
    else:
        want = torch.as_tensor(_np.asarray(indices))
    src = arr._data
    want = want.to(src.device, torch.int32)
    return RowSparseNDArray(src.index_select(0, want.long()), want,
                            arr.shape)


sparse_retain = retain


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``dot`` with sparse operands: csr x dense (and csr.T x dense) from
    the stored values; a sparse right operand as its dense value."""
    if isinstance(lhs, CSRNDArray):
        return NDArray(csr_dot(lhs.csr_tensor(), rhs._data, transpose_a,
                               transpose_b))
    from . import dot as dense_dot

    return dense_dot(lhs, NDArray(rhs._data) if isinstance(
        rhs, BaseSparseNDArray) else rhs, transpose_a=transpose_a,
        transpose_b=transpose_b)


def elemwise_add(lhs, rhs):
    """Two row-sparse arrays add by concatenation and ``compact()``; any
    other pair adds dense."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        dev = lhs.values_.device
        out = RowSparseNDArray(
            torch.cat([lhs.values_, rhs.values_.to(dev)]),
            torch.cat([lhs.indices_, rhs.indices_.to(dev)]), lhs.shape)
        return out.compact()
    return NDArray(lhs._data + rhs._data)


add = elemwise_add
