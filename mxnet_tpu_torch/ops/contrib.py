"""Contrib ops (PyTorch counterpart of ``mxnet_tpu/ops/contrib.py``):
flash attention, the boxes (``box_iou``, ``box_nms``, ``box_encode``,
``bipartite_matching``), the ROI poolings (``ROIPooling``, ``ROIAlign``,
``PSROIPooling``), ``DeformableConvolution``, ``CTCLoss`` and the rest
(count sketch, FFT, ``quadratic``, ``arange_like``, ``index_copy``,
``getnnz``, ``div_sqrt_dim``, ``SyncBatchNorm``).

NMS sorts with a stable argsort and runs its greedy pass as a loop over
the sorted rows, batched over images (:func:`greedy_keep`); the loop ends
at the last row that could still suppress.  The CTC recursion runs in log
space over time, with ``jnp.logaddexp``'s derivative rule, so an
infeasible label's loss and gradient are the reference's too.  ROI max
pooling takes its max over a bin's columns, then its rows (a tie inside a
bin shares the gradient per stage, where the reference shares it over
the bin).

``flash_attention`` over (B, T, H, D) goes to
:func:`ops.flash_attention.flash_attention`: on CUDA tensors its forward
launches the flash forward kernel and its backward the dQ and dK/dV
kernels; CPU tensors take their plain versions.  ``SyncBatchNorm`` with
an ``axis_name`` takes the f32 means of x and x^2 all-reduced over that
mesh axis (``parallel.collectives``, inside ``spmd(mesh)``); without one
it is ``BatchNorm`` on axis 1.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_attention
from .registry import register

__all__ = ["contrib_flash_attention", "count_sketch", "fft", "ifft",
           "quadratic", "arange_like", "index_copy", "getnnz",
           "div_sqrt_dim", "sync_batch_norm", "iou_matrix", "box_iou",
           "greedy_keep", "box_nms", "box_encode", "bipartite_matching",
           "roi_pooling", "roi_align", "psroi_pooling",
           "deformable_convolution", "logaddexp", "ctc_loss"]


@register("_contrib_flash_attention", aliases=("flash_attention",))
def contrib_flash_attention(q, k, v, causal=False, scale=None):
    """Attention over (B, T, H, D) q, k, v (``causal`` masks the future;
    ``scale`` defaults to ``1/sqrt(D)``)."""
    from .nn import attr_bool

    return flash_attention(q, k, v, attr_bool(causal),
                           None if scale is None else float(scale))


@register("_contrib_count_sketch")
def count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """Each column of ``data`` times its sign ``s``, summed into the
    output column ``h`` picks (reference: contrib/count_sketch.cc)."""
    N, D = data.shape
    idx = h.reshape(-1)[:D].to(torch.int32).long()
    sign = s.reshape(-1)[:D]
    out = torch.zeros((N, int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, data * sign)


def _wide(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@register("_contrib_fft")
def fft(data, compute_size=128):
    """The FFT over the last axis, real and imaginary parts interleaved
    (computed in complex64 for any input narrower than float64)."""
    c = torch.fft.fft(_wide(data), dim=-1)
    return torch.stack([c.real, c.imag], dim=-1).reshape(
        *data.shape[:-1], -1).to(data.dtype)


@register("_contrib_ifft")
def ifft(data, compute_size=128):
    """The inverse of ``_contrib_fft``'s layout, unnormalized (times the
    length, as the reference's cuFFT inverse)."""
    D = data.shape[-1] // 2
    c = _wide(data).reshape(*data.shape[:-1], D, 2)
    comp = torch.complex(c[..., 0], c[..., 1])
    return (torch.fft.ifft(comp, dim=-1).real * D).to(data.dtype)


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("_contrib_arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` in ``data``'s shape (or along ``axis``)."""
    n = data.numel() if axis is None else data.shape[int(axis)]
    out = start + step * torch.arange(n, dtype=torch.float32,
                                      device=data.device)
    if axis is None:
        out = out.reshape(data.shape)
    return out.to(data.dtype)


@register("_contrib_index_copy")
def index_copy(old, idx, new):
    """``old`` with its rows ``idx`` replaced by ``new``'s."""
    return old.index_copy(0, idx.to(torch.int32).long(), new)


@register("_contrib_getnnz", differentiable=False)
def getnnz(data, axis=None):
    """The non-zero count (over ``axis``), as float32."""
    nz = data != 0
    out = nz.sum() if axis is None else nz.sum(dim=int(axis))
    return out.to(torch.float32)


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """``data / sqrt(last dim)`` (reference: contrib/transformer-inl.h)."""
    return data / math.sqrt(data.shape[-1])


@register("_contrib_SyncBatchNorm",
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1)
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    output_mean_var=False, ndev=1, key="", axis_name=None,
                    _training=True):
    """Cross-device BatchNorm (reference: contrib/sync_batch_norm-inl.h):
    with ``axis_name`` the batch moments are the means over every rank of
    that mesh axis (var = E[x^2] - mean^2); ``ndev`` and ``key`` are
    accepted and unused."""
    from .nn import attr_bool, batch_norm

    if _training and not attr_bool(use_global_stats) and \
            axis_name is not None:
        from ..parallel.collectives import allreduce, axis_size

        red = tuple(i for i in range(data.ndim) if i != 1)
        xf = data.float()
        moments = torch.stack([xf.mean(dim=red), (xf * xf).mean(dim=red)])
        moments = allreduce(moments, axis_name) / axis_size(axis_name)
        mean, sq = moments[0], moments[1]
        var = sq - mean * mean
        shape = [1] * data.ndim
        shape[1] = data.shape[1]
        g = torch.ones_like(gamma) if attr_bool(fix_gamma) else gamma
        inv = torch.rsqrt(var + eps)
        out = (data - mean.reshape(shape).to(data.dtype)) \
            * (g * inv).reshape(shape).to(data.dtype) \
            + beta.reshape(shape).to(data.dtype)
        if output_mean_var:
            return out, mean, var
        return out
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=1,
                      _training=_training)


# ---------------------------------------------------------------------------
# boxes (src/operator/contrib/bounding_box.cc)
# ---------------------------------------------------------------------------

def _floats(v):
    """A tuple attribute given as a number, a sequence or its string."""
    if isinstance(v, (int, float)):
        return (float(v),)
    if isinstance(v, str):
        v = v.strip("()[] ")
        return tuple(float(x) for x in v.split(",") if x.strip())
    return tuple(float(x) for x in v)


def _corners(boxes):
    """Centre-format ``(x, y, w, h)`` boxes as corners."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


def iou_matrix(boxes_a, boxes_b, fmt="corner"):
    """IoU of (..., Na, 4) against (..., Nb, 4): (..., Na, Nb); 0 where
    the union is not positive."""
    if fmt == "center":
        boxes_a, boxes_b = _corners(boxes_a), _corners(boxes_b)
    al, at, ar, ab = (t[..., :, None] for t in boxes_a.unbind(-1))
    bl, bt, br, bb = (t[..., None, :] for t in boxes_b.unbind(-1))
    zero = torch.zeros((), dtype=boxes_a.dtype, device=boxes_a.device)
    iw = torch.maximum(zero, torch.minimum(ar, br) - torch.maximum(al, bl))
    ih = torch.maximum(zero, torch.minimum(ab, bb) - torch.maximum(at, bt))
    inter = iw * ih
    union = (ar - al) * (ab - at) + (br - bl) * (bb - bt) - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(inter))


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    return iou_matrix(lhs, rhs, fmt=format)


def greedy_keep(ious, keep, thresh, k):
    """The greedy pass of NMS over rows sorted by score, batched: row
    ``i < k``, if still kept, drops every later row whose IoU with it is
    above ``thresh``.  ``ious`` (B, k, N), ``keep`` (B, N) bool.  Rows
    past the last initially kept one change nothing, so the loop stops
    there (one read of the card; a hybridized block's program that runs
    it therefore stays uncaptured, as one with a ``Custom`` op does)."""
    from ..gluon import cached_op

    n = keep.shape[-1]
    if k <= 0 or n == 0 or keep.device.type == "meta":   # shapes only
        return keep
    cached_op.note_host_sync("box_nms")
    later = torch.arange(n, device=keep.device)[None, :] > \
        torch.arange(k, device=keep.device)[:, None]
    sup = (ious[:, :k] > thresh) & later[None]
    last = int(keep[:, :k].any(0).nonzero().max()) + 1 \
        if bool(keep[:, :k].any()) else 0
    for i in range(last):
        keep = keep & ~(sup[:, i] & keep[:, i:i + 1])
    return keep


@register("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS of (B, N, F) or (N, F) rows: sorted by score (stable),
    rows at or below ``valid_thresh`` and past ``topk`` dropped, each kept
    row suppressing the later ones it overlaps by more than
    ``overlap_thresh`` (of its class unless ``force_suppress``); the
    survivors compacted to the front in score order, -1 rows after."""
    from .nn import attr_bool

    batched = data.ndim == 3
    x = data if batched else data[None]
    B, N, _ = x.shape
    topk, cs = int(topk), int(coord_start)
    si, ii = int(score_index), int(id_index)
    scores = x[..., si]
    valid = scores > valid_thresh
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    rows = torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))
    keep = torch.gather(valid, 1, order)
    k = N if topk <= 0 else min(topk, N)
    if topk > 0:
        keep = keep & (torch.arange(N, device=x.device) < k)[None]
    boxes = rows[..., cs:cs + 4]
    ious = iou_matrix(boxes[:, :k], boxes, fmt=in_format)
    if ii >= 0 and not attr_bool(force_suppress):
        cls = rows[..., ii]
        ious = torch.where(cls[:, :k, None] == cls[:, None, :], ious,
                           torch.zeros_like(ious))
    keep = greedy_keep(ious, keep, float(overlap_thresh), k)
    out = torch.where(keep[..., None], rows, torch.full_like(rows, -1.0))
    comp = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    out = torch.gather(out, 1, comp[..., None].expand(-1, -1, out.shape[-1]))
    if out_format != in_format:
        bx = out[..., cs:cs + 4]
        if out_format == "center":
            x1, y1, x2, y2 = bx.unbind(-1)
            bx = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                              y2 - y1], -1)
        else:
            bx = _corners(bx)
        ok = out[..., si:si + 1] >= 0
        out = torch.cat([out[..., :cs], torch.where(ok, bx, out[..., cs:cs + 4]),
                         out[..., cs + 4:]], dim=-1)
    return out if batched else out[0]


@register("_contrib_box_encode")
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets of centre-format anchors against their matched
    references, and their mask (samples above 0.5)."""
    means, stds = _floats(means), _floats(stds)
    m = matches.to(torch.int32).long()
    ref = torch.gather(refs, 1, m[..., None].expand(*m.shape, 4))
    ax, ay, aw, ah = anchors.unbind(-1)
    gx, gy, gw, gh = ref.unbind(-1)
    eps = 1e-6
    aw_, ah_ = torch.clamp(aw, min=eps), torch.clamp(ah, min=eps)
    t0 = ((gx - ax) / aw_ - means[0]) / stds[0]
    t1 = ((gy - ay) / ah_ - means[1]) / stds[1]
    t2 = (torch.log(torch.clamp(gw / aw_, min=eps)) - means[2]) / stds[2]
    t3 = (torch.log(torch.clamp(gh / ah_, min=eps)) - means[3]) / stds[3]
    out = torch.stack([t0, t1, t2, t3], -1)
    mask = (samples > 0.5)[..., None]
    return (torch.where(mask, out, torch.zeros_like(out)),
            mask.to(out.dtype).expand(*mask.shape[:-1], 4))


@register("_contrib_bipartite_matching", differentiable=False, num_outputs=2)
def bipartite_matching(data, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy matching over a (..., N, M) score matrix: the best remaining
    pair is taken while it passes ``threshold``, its row and column then
    struck out; (row -> col, col -> row), -1 where unmatched."""
    from .nn import attr_bool

    scores = data.to(torch.float32)
    batch_shape = scores.shape[:-2]
    N, M = scores.shape[-2:]
    sgn = -1.0 if attr_bool(is_ascend) else 1.0
    mat = (scores.reshape(-1, N, M) * sgn).clone()
    Bf = mat.shape[0]
    dev = mat.device
    rmatch = torch.full((Bf, N), -1.0, device=dev)
    cmatch = torch.full((Bf, M), -1.0, device=dev)
    rows = torch.arange(Bf, device=dev)
    topk = int(topk)
    iters = min(N, M) if topk < 0 else min(topk, min(N, M))
    for _ in range(iters):
        idx = mat.reshape(Bf, -1).argmax(dim=1)
        r, c = idx // M, idx % M
        ok = mat[rows, r, c] > sgn * float(threshold)
        take_r = ok & (rmatch[rows, r] < 0)
        take_c = ok & (cmatch[rows, c] < 0)
        rmatch[rows, r] = torch.where(take_r, c.float(), rmatch[rows, r])
        cmatch[rows, c] = torch.where(take_c, r.float(), cmatch[rows, c])
        mat[rows, r, :] = -1e30
        mat[rows, :, c] = -1e30
    return (rmatch.reshape(batch_shape + (N,)).to(data.dtype),
            cmatch.reshape(batch_shape + (M,)).to(data.dtype))


# ---------------------------------------------------------------------------
# ROI poolings (roi_pooling.cc, contrib/roi_align.cc, psroi_pooling.cc)
# ---------------------------------------------------------------------------

def _bin_mask(start, end, size):
    """(..., size) bool: ``start <= i < end`` for each bin."""
    i = torch.arange(size, device=start.device)
    return (i >= start[..., None]) & (i < end[..., None])


@register("ROIPooling")
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max over each of ``pooled_size`` bins of each ROI (rois (R, 5):
    batch index, x1, y1, x2, y2, scaled and rounded, clamped to the map):
    (R, C, ph, pw)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    _, C, H, W = data.shape
    s = float(spatial_scale)
    b = rois[:, 0].to(torch.int32).long()

    def coord(v, hi):
        return torch.clamp(torch.round(v * s), 0, hi - 1).to(torch.int32) \
            .long()

    x1, y1 = coord(rois[:, 1], W), coord(rois[:, 2], H)
    x2, y2 = coord(rois[:, 3], W), coord(rois[:, 4], H)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    py = torch.arange(ph, device=data.device)[None]
    px = torch.arange(pw, device=data.device)[None]
    hs = y1[:, None] + torch.div(py * rh[:, None], ph, rounding_mode="floor")
    he = y1[:, None] - torch.div(-(py + 1) * rh[:, None], ph,
                                 rounding_mode="floor")
    ws = x1[:, None] + torch.div(px * rw[:, None], pw, rounding_mode="floor")
    we = x1[:, None] - torch.div(-(px + 1) * rw[:, None], pw,
                                 rounding_mode="floor")
    my = _bin_mask(hs, torch.maximum(he, hs + 1), H)     # (R, ph, H)
    mx = _bin_mask(ws, torch.maximum(we, ws + 1), W)     # (R, pw, W)
    img = data[b]                                        # (R, C, H, W)
    neg = torch.tensor(float("-inf"), dtype=data.dtype, device=data.device)
    # the max over a rectangle: over its columns, then its rows
    cols = torch.where(mx[:, None, None], img[:, :, :, None, :], neg) \
        .amax(dim=-1)                                    # (R, C, H, pw)
    rows = torch.where(my[:, None, :, :, None], cols[:, :, None], neg) \
        .amax(dim=3)                                     # (R, C, ph, pw)
    return rows


@register("_contrib_ROIAlign")
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """The mean of bilinear samples (``sample_ratio`` a side, or the map's
    bin size rounded up when not positive) in each bin of each ROI; a
    sample outside [-1, size] counts as 0."""
    from .nn import attr_bool

    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    _, C, H, W = data.shape
    if int(sample_ratio) > 0:
        sry = srx = int(sample_ratio)
    else:
        sry, srx = max(1, -(-H // ph)), max(1, -(-W // pw))
    off = 0.5 if attr_bool(aligned) else 0.0
    s = float(spatial_scale)
    b = rois[:, 0].to(torch.int32).long()
    x1, y1 = rois[:, 1] * s - off, rois[:, 2] * s - off
    x2, y2 = rois[:, 3] * s - off, rois[:, 4] * s - off
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bh, bw = rh / ph, rw / pw
    dev = data.device

    def samples(start, bsize, n, sr):
        cell = torch.arange(n, device=dev, dtype=data.dtype)
        sub = torch.arange(sr, device=dev, dtype=data.dtype) + 0.5
        return (start[:, None, None] + cell[None, :, None] * bsize[:, None, None]
                + sub[None, None, :] * bsize[:, None, None] / sr
                ).reshape(len(start), n * sr)

    def axis(v, size):
        inb = ((v >= -1.0) & (v <= size)).to(data.dtype)
        v = torch.clamp(v, 0.0, size - 1.0)
        v0 = torch.floor(v).to(torch.int32).long()
        v1 = torch.clamp(v0 + 1, max=size - 1)
        return v0, v1, v - v0, inb

    y0, y1_, ly, iny = axis(samples(y1, bh, ph, sry), H)     # (R, Sy)
    x0, x1_, lx, inx = axis(samples(x1, bw, pw, srx), W)     # (R, Sx)
    R = rois.shape[0]
    bb = b[:, None]
    top = data[bb, :, y0]                                     # (R, Sy, C, W)
    bot = data[bb, :, y1_]
    lyb = ly[:, :, None, None]
    rowv = top * (1 - lyb) + bot * lyb
    Sx = x0.shape[1]
    idx0 = x0[:, None, None, :].expand(R, rowv.shape[1], C, Sx)
    idx1 = x1_[:, None, None, :].expand(R, rowv.shape[1], C, Sx)
    lxb = lx[:, None, None, :]
    v = torch.gather(rowv, 3, idx0) * (1 - lxb) + \
        torch.gather(rowv, 3, idx1) * lxb                     # (R, Sy, C, Sx)
    v = v * iny[:, :, None, None] * inx[:, None, None, :]
    v = v.reshape(R, ph, sry, C, pw, srx).sum(dim=(2, 5)) / (sry * srx)
    return v.permute(0, 2, 1, 3)


@register("_contrib_PSROIPooling")
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0, pooled_size=7,
                  group_size=0):
    """Position-sensitive average pooling (R-FCN): bin (py, px) of output
    channel ``od`` averages its own input channel ``(od * G + gh) * G +
    gw`` over the bin (rounded ROI corners, no half-pixel offset)."""
    P = int(pooled_size)
    G = int(group_size) if group_size else P
    OD = int(output_dim)
    _, C, H, W = data.shape
    s = float(spatial_scale)
    b = rois[:, 0].to(torch.int32).long()
    x1, y1 = torch.round(rois[:, 1]) * s, torch.round(rois[:, 2]) * s
    x2 = torch.round(rois[:, 3] + 1.0) * s
    y2 = torch.round(rois[:, 4] + 1.0) * s
    bh = torch.clamp(y2 - y1, min=0.1) / P
    bw = torch.clamp(x2 - x1, min=0.1) / P
    p = torch.arange(P, device=data.device, dtype=data.dtype)[None]
    hs = torch.clamp(torch.floor(y1[:, None] + p * bh[:, None]), 0, H)
    he = torch.clamp(torch.ceil(y1[:, None] + (p + 1) * bh[:, None]), 0, H)
    ws = torch.clamp(torch.floor(x1[:, None] + p * bw[:, None]), 0, W)
    we = torch.clamp(torch.ceil(x1[:, None] + (p + 1) * bw[:, None]), 0, W)
    my = _bin_mask(hs, he, H).to(data.dtype)              # (R, P, H)
    mx = _bin_mask(ws, we, W).to(data.dtype)              # (R, P, W)
    g = torch.clamp(torch.arange(P, device=data.device) * G // P, 0, G - 1)
    cidx = ((torch.arange(OD, device=data.device)[:, None, None] * G
             + g[None, :, None]) * G + g[None, None, :])  # (OD, P, P)
    img = data[b].reshape(len(b), OD, G * G, H, W)
    sel = img[:, torch.arange(OD, device=data.device)[:, None, None],
              (cidx % (G * G))]                            # (R, OD, P, P, H, W)
    tot = (sel * my[:, None, :, None, :, None]
           * mx[:, None, None, :, None, :]).sum(dim=(-1, -2))
    cnt = torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :], min=1)
    empty = ((he <= hs)[:, :, None] | (we <= ws)[:, None, :])[:, None]
    return torch.where(empty, torch.zeros_like(tot), tot / cnt[:, None])


# ---------------------------------------------------------------------------
# deformable convolution (contrib/deformable_convolution.cc)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution")
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1: each tap samples the input bilinearly
    (zero outside) at its grid position plus its learned (y, x) offset
    (offset (B, 2 * ndg * kh * kw, Ho, Wo), channel-major over (group,
    tap, coordinate)), and the sampled columns are contracted with the
    grouped weights."""
    from .nn import attr_bool

    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph_, pw_ = int(pad[0]), int(pad[1])
    B, C, H, W = data.shape
    F_ = weight.shape[0]
    ndg, ng = int(num_deformable_group), int(num_group)
    Ho = (H + 2 * ph_ - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw_ - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    dev = data.device
    base_y = (torch.arange(Ho, device=dev) * sh - ph_)[:, None] + \
        (torch.arange(kh, device=dev) * dh)[None, :]         # (Ho, kh)
    base_x = (torch.arange(Wo, device=dev) * sw - pw_)[:, None] + \
        (torch.arange(kw, device=dev) * dw)[None, :]         # (Wo, kw)
    off = offset.reshape(B, ndg, K, 2, Ho, Wo)
    oy, ox = off[:, :, :, 0], off[:, :, :, 1]                # (B, ndg, K, Ho, Wo)
    taps_y = base_y.T.reshape(kh, 1, Ho, 1).expand(kh, kw, Ho, Wo) \
        .reshape(K, Ho, Wo)
    taps_x = base_x.T.reshape(1, kw, 1, Wo).expand(kh, kw, Ho, Wo) \
        .reshape(K, Ho, Wo)
    sy = taps_y[None, None] + oy
    sx = taps_x[None, None] + ox
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = (sy - y0).to(data.dtype), (sx - x0).to(data.dtype)
    y0i, x0i = y0.to(torch.int32).long(), x0.to(torch.int32).long()
    Cg = C // ndg
    flat = data.reshape(B, ndg, Cg, H * W)

    def corner(yi, xi, w_):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        lin = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)) \
            .reshape(B, ndg, 1, -1)
        g = torch.gather(flat, 3, lin.expand(B, ndg, Cg, lin.shape[-1]))
        g = g.reshape(B, ndg, Cg, K, Ho, Wo)
        return g * (valid.to(data.dtype) * w_)[:, :, None]

    cols = (corner(y0i, x0i, (1 - ly) * (1 - lx))
            + corner(y0i + 1, x0i, ly * (1 - lx))
            + corner(y0i, x0i + 1, (1 - ly) * lx)
            + corner(y0i + 1, x0i + 1, ly * lx))
    cols = cols.reshape(B, ng, C // ng, K, Ho, Wo)
    wg = weight.reshape(ng, F_ // ng, C // ng, K)
    out = torch.einsum("bgckhw,gfck->bgfhw", cols.float(), wg.float())
    out = out.reshape(B, F_, Ho, Wo).to(data.dtype)
    if not attr_bool(no_bias) and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# CTC (contrib/ctc_loss.cc)
# ---------------------------------------------------------------------------

def _replace_posinf(x):
    return torch.where(torch.isposinf(x), torch.zeros_like(x), x)


def _logaddexp_fwd(a, b):
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-delta.abs())))


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with its derivative rule: each input's cotangent
    is ``g * exp(x - out)`` (so where both inputs sit at the floor and the
    sum rounds back to it, each gets all of ``g``)."""

    @staticmethod
    def forward(ctx, a, b):
        out = _logaddexp_fwd(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _replace_posinf(out)
        return (g * torch.exp(_replace_posinf(a) - o),
                g * torch.exp(_replace_posinf(b) - o))


def logaddexp(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _LogAddExp.apply(a, b)


@register("_contrib_CTCLoss", aliases=("ctc_loss", "CTCLoss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """The CTC negative log likelihood of each sequence (data (T, B, A)
    activations, label (B, L)): the log-space alpha recursion over time
    with a floor of -1e30, its gradient autograd's.  ``blank_label=
    "first"``: blank 0, labels 1-based, 0 pads; ``"last"``: blank A - 1,
    labels 0-based, negative pads.  Returns (B,) in data's dtype."""
    from .nn import attr_bool

    T, B, A = data.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = data.device
    NEG = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    logp = torch.log_softmax(data.float(), dim=-1)
    lab = label.to(torch.int32).long()
    if blank_label == "first":
        blank = 0
        raw_len = (lab > 0).sum(dim=1)
    else:
        blank = A - 1
        raw_len = (lab >= 0).sum(dim=1)
        lab = torch.where(lab < 0, torch.zeros_like(lab), lab)
    lab_len = label_lengths.to(torch.int32).long() \
        if attr_bool(use_label_lengths) and label_lengths is not None \
        else raw_len
    seq_len = data_lengths.to(torch.int32).long() \
        if attr_bool(use_data_lengths) and data_lengths is not None \
        else torch.full((B,), T, dtype=torch.int64, device=dev)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    valid = torch.arange(S, device=dev)[None, :] < (2 * lab_len + 1)[:, None]
    emit = torch.gather(logp, 2, ext[None].expand(T, B, S))    # (T, B, S)
    floor = NEG.expand(B, S)
    alpha = torch.cat([emit[0][:, :1], floor[:, 1:]], dim=1)
    if S > 1:
        second = torch.where(lab_len > 0, emit[0][:, 1], NEG)
        alpha = torch.cat([alpha[:, :1], second[:, None], alpha[:, 2:]], 1)
    neg1, neg2 = NEG.expand(B, 1), NEG.expand(B, 2)
    for t in range(1, T):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]], 1)
                            if S > 1 else neg2[:, :S], NEG)
        tot = logaddexp(logaddexp(alpha, prev1), prev2)
        new = torch.where(valid, tot + emit[t], NEG)
        alpha = torch.where((t < seq_len)[:, None], new, alpha)
    end = 2 * lab_len
    a_last = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, NEG)
    return (-logaddexp(a_last, a_prev)).to(data.dtype)
