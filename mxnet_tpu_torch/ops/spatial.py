"""The spatial-transform ops (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``Correlation``, ``DeformablePSROIPooling``), the
legacy ``Crop`` op, the ``SVMOutput`` loss head, the sparse storage ops,
``_copyto`` and the OpenCV-style ``copyMakeBorder`` and ``cv_imresize``.

PyTorch counterpart of ``mxnet_tpu/ops/spatial.py``.  The samplers are
clipped gathers weighted bilinearly with in-bounds masks, their gradients
autograd's (an index's backward is an ``index_add``).  ``SVMOutput``'s
backward is its own (a
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

__all__ = ["grid_generator", "bilinear_sampler", "spatial_transformer",
           "correlation", "deformable_psroi_pooling", "cv_copy_make_border",
           "cv_imresize", "crop_legacy", "svm_output", "CsrTensor", "csr_dot",
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


# ---------------------------------------------------------------------------
# grid generation and bilinear sampling (grid_generator-inl.h,
# bilinear_sampler-inl.h, spatial_transformer-inl.h)
# ---------------------------------------------------------------------------

def _linspace(n, dtype, device):
    """``jnp.linspace(-1, 1, n)``: ``-1 * (1 - s) + 1 * s`` at ``s = i /
    (n - 1)``, the end point exact."""
    if n <= 1:
        return torch.full((n,), -1.0, dtype=dtype, device=device)
    s = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    out = -1.0 * (1 - s) + 1.0 * s
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def _affine_grid(theta, height, width):
    """theta (B, 6) -> the normalized sampling grid (B, 2, H, W), channel 0
    x and channel 1 y."""
    xs = _linspace(width, theta.dtype, theta.device)
    ys = _linspace(height, theta.dtype, theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dst = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones_like(gx).reshape(-1)])   # (3, H * W)
    src = theta.reshape(-1, 2, 3) @ dst
    return src.reshape(-1, 2, height, width)


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """``affine``: (B, 6) parameters -> the grid (B, 2, H, W) over
    ``target_shape``; ``warp``: a flow (B, 2, H, W) plus the identity,
    normalized to [-1, 1]."""
    if transform_type == "affine":
        return _affine_grid(data, int(target_shape[0]), int(target_shape[1]))
    if transform_type == "warp":
        _, _, H, W = data.shape
        gx = torch.arange(W, dtype=data.dtype, device=data.device) \
            .expand(H, W)
        gy = torch.arange(H, dtype=data.dtype, device=data.device)[:, None] \
            .expand(H, W)
        ident = torch.stack([gx, gy])[None]
        denom = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], dtype=data.dtype,
                             device=data.device).reshape(1, 2, 1, 1)
        return (data + ident) / denom - 1.0
    raise ValueError(f"unknown transform_type {transform_type!r}")


def _bilinear_gather(data, x, y):
    """data (B, C, H, W) sampled at pixel coordinates x, y (B, Ho, Wo):
    the four neighbours weighted bilinearly, zero outside the image."""
    B, C, H, W = data.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    b = torch.arange(B, device=data.device)[:, None, None]
    out = torch.zeros((B, C) + tuple(x.shape[1:]), dtype=data.dtype,
                      device=data.device)
    for yi in (y0, y0 + 1.0):
        for xi in (x0, x0 + 1.0):
            wgt = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
            inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            xc = torch.clamp(xi, 0, W - 1).to(torch.int32).long()
            yc = torch.clamp(yi, 0, H - 1).to(torch.int32).long()
            g = data[b, :, yc, xc].permute(0, 3, 1, 2)     # (B, C, Ho, Wo)
            out = out + (wgt * inb)[:, None] * g
    return out


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=False):
    """data (B, C, H, W) sampled at ``grid`` (B, 2, Ho, Wo), normalized to
    [-1, 1], channel 0 x and channel 1 y."""
    _, _, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, x, y)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """The affine parameters ``loc`` (B, 6) warp ``data`` onto
    ``target_shape``, sampled bilinearly."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("SpatialTransformer: affine and bilinear only")
    grid = _affine_grid(loc, int(target_shape[0]), int(target_shape[1]))
    return bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# Correlation (FlowNet; correlation-inl.h)
# ---------------------------------------------------------------------------

@register("Correlation", num_outputs=1)
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """The cost volume of two maps (B, C, H, W): for each displacement on a
    ``stride2`` grid within ``max_displacement``, the product (or absolute
    difference) summed over channels and a ``kernel_size`` window, over
    ``kernel_size**2 * C``: (B, D * D, Ho, Wo)."""
    from .nn import attr_bool

    k = int(kernel_size)
    md = int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    B, C, H, W = data1.shape
    kr = (k - 1) // 2
    border = md + kr
    Hp, Wp = H + 2 * pad, W + 2 * pad
    Ho = -(-(Hp - 2 * border) // s1)
    Wo = -(-(Wp - 2 * border) // s1)
    rad = md // s2
    pa = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    pb = torch.nn.functional.pad(data2, (pad + md,) * 4)
    norm = float(k * k * C)
    lo = (k - 1) // 2
    mult = attr_bool(is_multiply, True)
    planes = []
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            oy, ox = md + dy * s2, md + dx * s2
            shifted = pb[:, :, oy:oy + Hp, ox:ox + Wp]
            prod = pa * shifted if mult else (pa - shifted).abs()
            chan = prod.sum(dim=1)                          # (B, Hp, Wp)
            # the k x k window sum, "SAME" padded
            padded = torch.nn.functional.pad(chan, (lo, k - 1 - lo,
                                                    lo, k - 1 - lo))
            win = sum(padded[:, i:i + Hp, j:j + Wp]
                      for i in range(k) for j in range(k))
            centers = win[:, border:border + (Ho - 1) * s1 + 1:s1,
                          border:border + (Wo - 1) * s1 + 1:s1]
            planes.append(centers / norm)
    return torch.stack(planes, dim=1)


# ---------------------------------------------------------------------------
# deformable position-sensitive ROI pooling
# (contrib/deformable_psroi_pooling-inl.h)
# ---------------------------------------------------------------------------

@register("_contrib_DeformablePSROIPooling", num_outputs=2)
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=1, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Position-sensitive ROI pooling with learned per-part offsets:
    ``sample_per_part``² bilinear samples a bin (at sub-bin origins, moved
    by the bin's class offset from ``trans`` (R, 2 * classes, part, part)
    times ``trans_std`` and the ROI's size), those inside [-0.5, size -
    0.5] averaged: (out (R, output_dim, P, P), the in-bounds counts)."""
    from .nn import attr_bool

    P, G, OD = int(pooled_size), int(group_size), int(output_dim)
    spp = int(sample_per_part)
    part = int(part_size) or P
    scale, tstd = float(spatial_scale), float(trans_std)
    _, C, H, W = data.shape
    dev, dt = data.device, data.dtype
    ii, jj = torch.meshgrid(torch.arange(P, device=dev),
                            torch.arange(P, device=dev), indexing="ij")
    ph = torch.clamp(ii * part // P, max=part - 1)
    pw = torch.clamp(jj * part // P, max=part - 1)
    gh = torch.clamp(ii * G // P, max=G - 1)
    gw = torch.clamp(jj * G // P, max=G - 1)
    cidx = (torch.arange(OD, device=dev)[:, None, None] * G + gh) * G + gw
    use_trans = not (attr_bool(no_trans) or trans is None)
    sy, sx = torch.meshgrid(torch.arange(spp, device=dev, dtype=torch.float32),
                            torch.arange(spp, device=dev, dtype=torch.float32),
                            indexing="ij")
    sx = sx.reshape(-1, 1, 1, 1)                            # (S, 1, 1, 1)
    sy = sy.reshape(-1, 1, 1, 1)
    R = rois.shape[0]
    b = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    w = torch.clamp((torch.round(rois[:, 3]) + 1.0) * scale - 0.5 - x1,
                    min=0.1)
    h = torch.clamp((torch.round(rois[:, 4]) + 1.0) * scale - 0.5 - y1,
                    min=0.1)
    bin_w, bin_h = w / P, h / P
    rs = (R, 1, 1, 1, 1)
    if use_trans:
        ncls = max(1, trans.shape[1] // 2)
        cls = torch.arange(OD, device=dev) * ncls // OD
        dx = trans[:, 2 * cls][:, :, ph, pw] * tstd * w.reshape(R, 1, 1, 1)
        dy = trans[:, 2 * cls + 1][:, :, ph, pw] * tstd * h.reshape(R, 1, 1, 1)
        dx, dy = dx[:, None], dy[:, None]                   # (R, 1, OD, P, P)
    else:
        dx = dy = torch.zeros((1, 1, 1, 1, 1), dtype=dt, device=dev)
    full = (R, sx.shape[0], OD, P, P)
    xx = (x1.reshape(rs) + jj * bin_w.reshape(rs) + sx[None]
          * (bin_w.reshape(rs) / spp) + dx).expand(full)
    yy = (y1.reshape(rs) + ii * bin_h.reshape(rs) + sy[None]
          * (bin_h.reshape(rs) / spp) + dy).expand(full)
    inb = ((xx >= -0.5) & (xx <= W - 0.5) & (yy >= -0.5)
           & (yy <= H - 0.5)).to(dt)
    xc = torch.clamp(xx, 0.0, W - 1.0)
    yc = torch.clamp(yy, 0.0, H - 1.0)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    x1_ = torch.clamp(x0 + 1, max=W - 1.0)
    y1_ = torch.clamp(y0 + 1, max=H - 1.0)
    fx, fy = xc - x0, yc - y0
    flat = data.reshape(data.shape[0], -1)[b]               # (R, C*H*W)
    chan = cidx.expand(full) * (H * W)

    def at(yv, xv):
        lin = chan + yv.to(torch.int32).long() * W + xv.to(torch.int32).long()
        return torch.gather(flat, 1, lin.reshape(R, -1)).reshape(full)

    vals = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1_))
            + fy * ((1 - fx) * at(y1_, x0) + fx * at(y1_, x1_)))
    cnt = inb.sum(dim=1)                                    # (R, OD, P, P)
    pooled = torch.where(cnt > 0, (vals * inb).sum(dim=1)
                         / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    return pooled, cnt


# ---------------------------------------------------------------------------
# the copy and the OpenCV-style image helpers
# ---------------------------------------------------------------------------

@register("_copyto")
def _copyto(data, ctx=None):
    """The copy between contexts; the NDArray front end places it."""
    return data


@register("_cvcopyMakeBorder", aliases=("copyMakeBorder",))
def cv_copy_make_border(data, top=0, bot=0, left=0, right=0, type=0,
                        value=0.0):
    """An HWC (or HW) image padded with a constant border."""
    pads = (int(left), int(right), int(top), int(bot))
    if data.ndim == 3:
        pads = (0, 0) + pads
    return torch.nn.functional.pad(data, pads, value=float(value))


@register("_cvimresize", aliases=("cv_imresize",))
def cv_imresize(data, w=0, h=0, interp=1):
    """An HWC image resized to ``h`` x ``w`` (``interp`` as OpenCV's: 0
    nearest, 1 linear, 2 cubic, others linear), in its own dtype (a float
    result truncates and saturates into an integer one)."""
    from .image_ops import scale_resize
    from .tensor import cast

    method = {0: "nearest", 1: "linear", 2: "cubic"}.get(int(interp),
                                                         "linear")
    shape = (int(h), int(w)) + tuple(data.shape[2:])
    out = scale_resize(data.to(torch.float32), shape, method)
    return cast(out, data.dtype)
