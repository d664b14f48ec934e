"""The legacy ``Crop`` op, the ``SVMOutput`` loss head and the sparse
storage ops.

PyTorch counterpart of ``mxnet_tpu/ops/spatial.py`` (the grid sampler,
spatial transformer, correlation and the rest are ROADMAP.md Queue 1,
item 6g).  ``SVMOutput``'s backward is its own (a
``torch.autograd.Function``), the reference's custom vjp: the L1 or L2
hinge gradient, whatever the incoming cotangent.

Sparse storage is an NDArray concept (``ndarray/sparse.py``); the
registered ops see dense tensors, as the reference's do: ``cast_storage``
is the identity there, ``_sparse_retain`` and the ``_scatter_*`` ops mask
by the rows or the non-zero pattern.  One graph value is not a tensor: a
variable bound with ``stype="csr"`` reaches its consumer as a
:class:`CsrTensor` (``data``, ``indices``, ``indptr`` on the card, never a
dense batch), which ``dot`` takes as its left operand (:func:`csr_dot`: a
gather and a per-row segment sum; the dense operand's gradient is
autograd's ``index_add_``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import tensor as _tensor  # noqa: F401  (registers Embedding)
from .registry import alias, register

__all__ = ["crop_legacy", "svm_output", "CsrTensor", "csr_dot",
           "cast_storage_op", "sparse_retain_op", "scatter_plus_scalar",
           "scatter_minus_scalar", "scatter_elemwise_div", "scatter_set_nd"]


@register("Crop")
def crop_legacy(*args, offset=(0, 0), h_w=(0, 0), center_crop=False,
                num_args=1):
    """The spatial dims (NCHW) of ``data`` cropped to ``h_w``, or to those
    of a second ``crop_like`` input, from ``offset`` (or centred with
    ``center_crop``) (reference: src/operator/crop-inl.h)."""
    data = args[0]
    if len(args) >= 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


def _svm_grad(data, label, margin, reg_coef, use_linear):
    """The hinge gradient of each row of ``data`` (flattened past the
    batch axis) against its integer label: L1-SVM's subgradient with
    ``use_linear``, else L2-SVM's (reference: svm_output.cc:31-66)."""
    x = data.reshape(data.shape[0], -1)
    k = label.reshape(-1).to(torch.int32).long()
    onehot = (k[:, None] == torch.arange(x.shape[1], device=x.device)).to(
        x.dtype)
    if use_linear:
        at_k = -(margin > x).to(x.dtype) * reg_coef
        rest = (margin > -x).to(x.dtype) * reg_coef
    else:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        at_k = -reg_coef * torch.where(margin > x, 2.0 * (margin - x), zero)
        rest = -reg_coef * torch.where(margin > -x, -2.0 * (margin + x),
                                       zero)
    return (onehot * at_k + (1.0 - onehot) * rest).reshape(data.shape)


class _SVMOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        ctx.save_for_backward(data, label)
        ctx.cfg = cfg
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return _svm_grad(data, label, *ctx.cfg), None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Hinge-loss output head: the forward is the identity, the backward
    the L1/L2 SVM gradient."""
    from .nn import attr_bool

    cfg = (float(margin), float(regularization_coefficient),
           attr_bool(use_linear))
    return _SVMOutputFn.apply(data, label, cfg)


# ---------------------------------------------------------------------------
# sparse storage (src/operator/tensor/cast_storage.cc, sparse_retain.cc,
# dot.cc's csr paths)
# ---------------------------------------------------------------------------

class CsrTensor(NamedTuple):
    """A CSR matrix as a graph value: ``data`` (nnz,), ``indices`` (nnz,)
    column ids, ``indptr`` (rows + 1,), the dense ``shape``, and
    ``row_ids`` (nnz,), each stored value's row."""
    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: Tuple[int, int]
    row_ids: torch.Tensor

    @staticmethod
    def make(data, indices, indptr, shape) -> "CsrTensor":
        nnz = data.shape[0]
        pos = torch.arange(nnz, device=indptr.device, dtype=indptr.dtype)
        rows = torch.searchsorted(indptr, pos, right=True) - 1
        return CsrTensor(data, indices.long(), indptr, tuple(shape),
                         rows.long())

    def dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_put_((self.row_ids, self.indices), self.data,
                              accumulate=True)


def csr_dot(lhs: CsrTensor, rhs: torch.Tensor, transpose_a=False,
            transpose_b=False) -> torch.Tensor:
    """``dot(csr, dense)`` (``csr.T`` with ``transpose_a``) from the stored
    values only: each value times its column's row of ``rhs`` (a gather),
    summed into its row (``index_add``); differentiable in ``rhs``."""
    if transpose_b and rhs.ndim > 1:
        rhs = rhs.transpose(-1, -2)
    vec = rhs.ndim == 1
    r = rhs.unsqueeze(1) if vec else rhs
    src, dst = (lhs.row_ids, lhs.indices) if transpose_a else \
        (lhs.indices, lhs.row_ids)
    rows = lhs.shape[1] if transpose_a else lhs.shape[0]
    prod = r.index_select(0, src) * lhs.data.to(r.dtype).unsqueeze(1)
    out = torch.zeros((rows, r.shape[1]), dtype=prod.dtype,
                      device=prod.device).index_add(0, dst, prod)
    return out.squeeze(1) if vec else out


@register("cast_storage")
def cast_storage_op(data, stype="default"):
    """The identity on a dense value; the conversion itself is
    ``nd.cast_storage`` (``ndarray/sparse.py``)."""
    if isinstance(data, CsrTensor):
        return data.dense()
    return data


@register("_sparse_retain")
def sparse_retain_op(data, indices):
    """Every row of ``data`` zeroed but ``indices`` (the dense form of the
    row-sparse retain); a negative index counts from the end, one out of
    range is dropped, as the reference's scatter drops it."""
    n = data.shape[0]
    idx = indices.to(torch.int32).long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    mask = torch.zeros((n + 1,), dtype=data.dtype, device=data.device)
    mask[idx] = 1
    return data * mask[:n].reshape((-1,) + (1,) * (data.ndim - 1))


@register("_scatter_plus_scalar")
def scatter_plus_scalar(data, scalar=0.0):
    """``scalar`` added to the non-zero entries only."""
    return torch.where(data != 0, data + scalar, data)


@register("_scatter_minus_scalar")
def scatter_minus_scalar(data, scalar=0.0):
    return torch.where(data != 0, data - scalar, data)


@register("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs):
    return torch.where(lhs != 0, lhs / rhs, lhs)


@register("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices):
    """``lhs`` with ``rhs`` written at the n-d ``indices`` (one row of
    ``indices`` per leading axis; reference: indexing_op.cc)."""
    return torch.index_put(lhs, tuple(indices.long()), rhs)


# the reference's SparseEmbedding: a dense gather with a dense gradient
alias("_contrib_SparseEmbedding", "Embedding")
