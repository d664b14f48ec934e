"""SSD and RPN detection ops (PyTorch counterpart of
``mxnet_tpu/ops/detection.py``; reference: src/operator/contrib/
multibox_*.cc, proposal.cc): ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` and ``Proposal``/``MultiProposal``.

Fixed shapes, as the reference's: anchors are arithmetic, matching an
argmax assignment (the first index on ties) with each valid ground truth
forcing its best anchor, detection a decode then ``box_nms``, and the
proposals the top-k slots after NMS.  Where two ground truths force the
same anchor, the later one (the larger index) takes it, the order in which
the reference's CPU scatter applies its writes; the port makes that choice
with a max-reduction, so it is the same on the card.
"""
from __future__ import annotations

import math

import torch

from .contrib import _floats, box_nms, greedy_keep, iou_matrix
from .registry import register

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "proposal"]


@register("_contrib_MultiBoxPrior", differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Corner-format anchors of each cell of ``data``'s (H, W) map: every
    size at ratio 1, then ``ratios[1:]`` at the first size (widths times
    H / W, so anchors are square in pixels): (1, H * W * A, 4)."""
    from .nn import attr_bool

    sizes, ratios = _floats(sizes), _floats(ratios)
    steps, offsets = _floats(steps), _floats(offsets)
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if len(steps) > 1 and steps[1] > 0 else 1.0 / W
    f32 = torch.float32
    cy = (torch.arange(H, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=f32, device=dev) + offsets[1]) * step_x
    aspect = H / W
    half_w = [s * aspect / 2 for s in sizes]
    half_h = [s / 2 for s in sizes]
    for r in ratios[1:]:
        sr = float(math.sqrt(r))
        half_w.append(sizes[0] * aspect * sr / 2)
        half_h.append(sizes[0] / sr / 2)
    hw = torch.tensor(half_w, dtype=f32, device=dev)
    hh = torch.tensor(half_h, dtype=f32, device=dev)
    A = hw.shape[0]
    gy = cy[:, None, None].expand(H, W, A)
    gx = cx[None, :, None].expand(H, W, A)
    anchors = torch.stack([gx - hw, gy - hh, gx + hw, gy + hh], dim=-1)
    anchors = anchors.reshape(1, H * W * A, 4)
    if attr_bool(clip):
        anchors = torch.clamp(anchors, 0.0, 1.0)
    return anchors


def _center_form(boxes):
    l, t, r, b = boxes.unbind(-1)
    return (l + r) / 2, (t + b) / 2, r - l, b - t


@register("_contrib_MultiBoxTarget", differentiable=False, num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors (1, N, 4) to ground truths (B, M, 5: class and
    corners, -1 rows padding): (loc_target (B, N * 4), loc_mask (B, N * 4),
    cls_target (B, N)), class 0 the background and a match gt class + 1;
    with ``negative_mining_ratio`` the unmatched anchors start at
    ``ignore_label`` and the hardest negatives become background."""
    var = _floats(variances)
    anchors = anchor[0]                                   # (N, 4)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = anchors.device
    valid = label[..., 0] >= 0                            # (B, M)
    gt = label[..., 1:5]
    iou = iou_matrix(anchors.expand(B, N, 4), gt)         # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)                           # first on ties
    best_anchor = iou.argmax(dim=1)                       # (B, M)
    # each valid gt forces its best anchor; where two share one, the
    # larger gt index wins (the reference's last write)
    gt_ids = torch.arange(M, device=dev).expand(B, M)
    forced_gt = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    forced_gt = forced_gt.scatter_reduce(
        1, torch.where(valid, best_anchor, torch.zeros_like(best_anchor)),
        torch.where(valid, gt_ids, torch.full_like(gt_ids, -1)), "amax")
    forced = forced_gt >= 0
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, forced_gt, best_gt)      # (B, N)
    gt_cls = torch.gather(label[..., 0], 1, gt_idx)
    zero = torch.zeros((), dtype=label.dtype, device=dev)
    cls_t = torch.where(matched, gt_cls + 1.0, zero)
    if negative_mining_ratio > 0:
        prob = torch.softmax(cls_pred, dim=1)             # (B, C, N)
        neg_score = prob[:, 1:].amax(dim=1)               # (B, N)
        candidate = ~matched & (best_iou < negative_mining_thresh)
        num_pos = matched.sum(dim=1, keepdim=True).to(torch.float32)
        num_neg = torch.clamp(num_pos * float(negative_mining_ratio),
                              min=float(minimum_negative_samples))
        order = torch.argsort(-torch.where(
            candidate, neg_score, torch.full_like(neg_score, float("-inf"))),
            dim=1, stable=True)
        rank = torch.empty((B, N), dtype=torch.float32, device=dev)
        rank.scatter_(1, order, torch.arange(
            N, dtype=torch.float32, device=dev).expand(B, N).contiguous())
        chosen = candidate & (rank < num_neg)
        cls_t = torch.where(matched, cls_t, torch.where(
            chosen, zero, torch.full_like(cls_t, float(ignore_label))))
    ax, ay, aw, ah = _center_form(anchors)
    gbox = torch.gather(gt, 1, gt_idx[..., None].expand(B, N, 4))
    gx, gy, gw, gh = _center_form(gbox)
    eps = 1e-8
    aw_, ah_ = torch.clamp(aw, min=eps), torch.clamp(ah, min=eps)
    tx = (gx - ax) / aw_ / var[0]
    ty = (gy - ay) / ah_ / var[1]
    tw = torch.log(torch.clamp(gw, min=eps) / aw_) / var[2]
    th = torch.log(torch.clamp(gh, min=eps) / ah_) / var[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)         # (B, N, 4)
    mask = matched[..., None].to(loc_t.dtype)
    return ((loc_t * mask).reshape(B, -1),
            mask.expand(B, N, 4).reshape(B, -1), cls_t)


@register("_contrib_MultiBoxDetection", differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode (B, C, N) class probabilities and (B, N * 4) offsets
    against the anchors, keep each anchor's best foreground class above
    ``threshold``, then ``box_nms``: (B, N, 6) rows [class, score, l, t, r,
    b], class -1 for the dropped ones."""
    from .nn import attr_bool

    var = _floats(variances)
    anchors = anchor[0]
    ax, ay, aw, ah = _center_form(anchors)
    B = cls_prob.shape[0]
    d = loc_pred.reshape(B, -1, 4)
    cx = ax + d[..., 0] * var[0] * aw
    cy = ay + d[..., 1] * var[1] * ah
    w = aw * torch.exp(d[..., 2] * var[2])
    h = ah * torch.exp(d[..., 3] * var[3])
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if attr_bool(clip):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    best = fg.argmax(dim=1)
    score = torch.gather(fg, 1, best[:, None])[:, 0]
    cls_id = torch.where(score > threshold, best.to(cls_prob.dtype),
                         torch.full_like(score, -1.0))
    score = torch.where(cls_id >= 0, score, torch.zeros_like(score))
    det = torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


@register("_contrib_Proposal", aliases=("_contrib_MultiProposal",),
          differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals: anchors of each cell (the reference's rounding of
    the ``feature_stride`` base box), decoded by ``bbox_pred``, clipped to
    the image (``im_info`` (B, 3): height, width, scale), boxes under the
    minimum size dropped, the top ``rpn_pre_nms_top_n`` by score through a
    greedy NMS at ``threshold``, the best ``rpn_post_nms_top_n`` kept:
    (B * post, 5) rows [batch index, l, t, r, b] (and their scores with
    ``output_score``)."""
    from .nn import attr_bool

    scales, ratios = _floats(scales), _floats(ratios)
    B, _, H, W = cls_prob.shape
    A = len(scales) * len(ratios)
    dev = cls_prob.device
    f32 = torch.float32
    base = float(feature_stride)
    ctr = 0.5 * (base - 1.0)
    ws, hs = [], []
    for r in ratios:
        size_r = math.floor(base * base / r)
        new_w0 = math.floor(math.sqrt(size_r) + 0.5)
        for s in scales:
            ws.append(new_w0 * s)
            hs.append(math.floor(new_w0 * r + 0.5) * s)
    ws = torch.tensor(ws, dtype=f32, device=dev)
    hs = torch.tensor(hs, dtype=f32, device=dev)
    sx = torch.arange(W, dtype=f32, device=dev) * float(feature_stride)
    sy = torch.arange(H, dtype=f32, device=dev) * float(feature_stride)
    cy, cx = torch.meshgrid(sy, sx, indexing="ij")
    anchors = torch.stack([
        cx[..., None] + ctr - 0.5 * (ws - 1.0),
        cy[..., None] + ctr - 0.5 * (hs - 1.0),
        cx[..., None] + ctr + 0.5 * (ws - 1.0),
        cy[..., None] + ctr + 0.5 * (hs - 1.0)], dim=-1).reshape(-1, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    d = bbox_pred.permute(0, 2, 3, 1).reshape(B, -1, 4)
    l, t, r, b = (anchors[:, i:i + 1] for i in range(4))
    aw, ah = r - l + 1.0, b - t + 1.0
    acx, acy = l + 0.5 * (aw - 1.0), t + 0.5 * (ah - 1.0)
    px = d[..., 0:1] * aw + acx
    py = d[..., 1:2] * ah + acy
    pw = torch.exp(torch.clamp(d[..., 2:3], -10, 10)) * aw
    ph = torch.exp(torch.clamp(d[..., 3:4], -10, 10)) * ah
    boxes = torch.cat([px - 0.5 * (pw - 1.0), py - 0.5 * (ph - 1.0),
                       px + 0.5 * (pw - 1.0), py + 0.5 * (ph - 1.0)], -1)
    zero = torch.zeros((), dtype=boxes.dtype, device=dev)
    hmax = (im_info[:, 0] - 1.0)[:, None]
    wmax = (im_info[:, 1] - 1.0)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), wmax),
        torch.minimum(torch.maximum(boxes[..., 1], zero), hmax),
        torch.minimum(torch.maximum(boxes[..., 2], zero), wmax),
        torch.minimum(torch.maximum(boxes[..., 3], zero), hmax)], -1)
    min_size = (float(rpn_min_size) * im_info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1.0) >= min_size)
    fg = torch.where(keep, fg, torch.full_like(fg, float("-inf")))
    pre_n = min(int(rpn_pre_nms_top_n), fg.shape[1])
    top_scores, top_idx = _top_k(fg, pre_n)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, pre_n, 4))
    ious = iou_matrix(top_boxes, top_boxes)
    alive = greedy_keep(ious, top_scores > float("-inf"), float(threshold),
                        pre_n)
    score_alive = torch.where(alive, top_scores,
                              torch.full_like(top_scores, float("-inf")))
    post_n = min(int(rpn_post_nms_top_n), pre_n)
    keep_scores, keep_idx = _top_k(score_alive, post_n)
    rois = torch.gather(top_boxes, 1, keep_idx[..., None].expand(B, post_n, 4))
    batch_idx = torch.arange(B, dtype=rois.dtype, device=dev)[:, None, None] \
        .expand(B, post_n, 1)
    out = torch.cat([batch_idx, rois], dim=-1).reshape(-1, 5)
    if attr_bool(output_score):
        return out, keep_scores.reshape(-1, 1)
    return out


def _top_k(x, k):
    """``lax.top_k`` over the last axis: the k largest, ties in index
    order."""
    order = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.gather(x, -1, order), order
