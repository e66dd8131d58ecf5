"""Box arithmetic on tensors, Detectron "+1" convention.

Port of ``detectorch_tpu/ops/boxes.py``: the +1 width/height convention, the
exp clip log(1000/16) and the "-1" in the decoded x2/y2. Boxes are
(x1, y1, x2, y2) in the last axis, shape (..., 4). Bounds such as ``height``
may be Python numbers or tensors that broadcast against ``boxes[..., 0]``
(e.g. (B, 1) for per-image bounds over (B, N, 4) boxes).
"""

from __future__ import annotations

import numpy as np
import torch

from detectorch_tpu_torch.config import BBOX_XFORM_CLIP


def boxes_area(boxes):
    """Area with the +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w * h


def clip_boxes(boxes, height, width):
    """Clip to [0, w-1] x [0, h-1]; works on (..., 4) and tiled (..., 4K).

    Tensor bounds broadcast against ``boxes.shape[:-1]``."""
    shape = boxes.shape
    b = boxes.reshape(shape[:-1] + (-1, 4))
    # one trailing axis for the K boxes of a tiled row
    h1 = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)[..., None] - 1.0
    w1 = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)[..., None] - 1.0
    # jnp.clip(x, 0, hi) == minimum(maximum(x, 0), hi)
    x1 = torch.minimum(torch.clamp_min(b[..., 0], 0.0), w1)
    y1 = torch.minimum(torch.clamp_min(b[..., 1], 0.0), h1)
    x2 = torch.minimum(torch.clamp_min(b[..., 2], 0.0), w1)
    y2 = torch.minimum(torch.clamp_min(b[..., 3], 0.0), h1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(shape)


def bbox_transform(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    """Decode regression deltas: boxes (..., N, 4), deltas (..., N, 4K) ->
    (..., N, 4K) boxes."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (-1, 4))
    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp_max(d[..., 2] / ww, BBOX_XFORM_CLIP)
    dh = torch.clamp_max(d[..., 3] / wh, BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w - 1.0,
            pred_ctr_y + 0.5 * pred_h - 1.0,
        ],
        dim=-1,
    )
    return out.reshape(shape)


def bbox_transform_inv(boxes, gt_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode regression targets on the device: boxes, gt_boxes (..., 4)
    (broadcasting) -> (..., 4) [tx, ty, tw, th], JAX's
    ``ops.boxes.bbox_transform_inv`` term for term."""
    ex_w = boxes[..., 2] - boxes[..., 0] + 1.0
    ex_h = boxes[..., 3] - boxes[..., 1] + 1.0
    ex_cx = boxes[..., 0] + 0.5 * ex_w
    ex_cy = boxes[..., 1] + 0.5 * ex_h
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gt_cx = gt_boxes[..., 0] + 0.5 * gt_w
    gt_cy = gt_boxes[..., 1] + 0.5 * gt_h
    wx, wy, ww, wh = weights
    return torch.stack(
        [
            wx * (gt_cx - ex_cx) / ex_w,
            wy * (gt_cy - ex_cy) / ex_h,
            ww * torch.log(gt_w / ex_w),
            wh * torch.log(gt_h / ex_h),
        ],
        dim=-1,
    )


def bbox_transform_inv_np(boxes, gt_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode regression targets in numpy, for host-side data preparation
    (roidb targets, the roi sampler): boxes, gt_boxes (..., 4) ->
    (..., 4) [tx, ty, tw, th], fp32. Copy of the JAX package's
    ``ops.boxes.bbox_transform_inv_np``, whose module imports JAX."""
    boxes = np.asarray(boxes, np.float32)
    gt_boxes = np.asarray(gt_boxes, np.float32)
    ex_w = boxes[..., 2] - boxes[..., 0] + 1.0
    ex_h = boxes[..., 3] - boxes[..., 1] + 1.0
    ex_cx = boxes[..., 0] + 0.5 * ex_w
    ex_cy = boxes[..., 1] + 0.5 * ex_h
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gt_cx = gt_boxes[..., 0] + 0.5 * gt_w
    gt_cy = gt_boxes[..., 1] + 0.5 * gt_h
    wx, wy, ww, wh = weights
    return np.stack(
        [
            wx * (gt_cx - ex_cx) / ex_w,
            wy * (gt_cy - ex_cy) / ex_h,
            ww * np.log(gt_w / ex_w),
            wh * np.log(gt_h / ex_h),
        ],
        axis=-1,
    )


def bbox_overlaps(boxes, query_boxes):
    """Dense IoU, +1 convention: boxes (..., N, 4), query (..., K, 4) ->
    (..., N, K)."""
    area_q = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0
    )
    area_b = (boxes[..., 2] - boxes[..., 0] + 1.0) * (
        boxes[..., 3] - boxes[..., 1] + 1.0
    )
    iw = (
        torch.minimum(boxes[..., :, None, 2], query_boxes[..., None, :, 2])
        - torch.maximum(boxes[..., :, None, 0], query_boxes[..., None, :, 0])
        + 1.0
    )
    ih = (
        torch.minimum(boxes[..., :, None, 3], query_boxes[..., None, :, 3])
        - torch.maximum(boxes[..., :, None, 1], query_boxes[..., None, :, 1])
        + 1.0
    )
    inter = torch.clamp_min(iw, 0.0) * torch.clamp_min(ih, 0.0)
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


BOX_VOTING_METHODS = ("ID", "TEMP_AVG", "AVG", "IOU_AVG", "GENERALIZED_AVG", "QUASI_SUM")


def box_voting(top_boxes, top_scores, all_boxes, all_scores, all_valid,
               thresh: float, scoring_method: str = "ID", beta: float = 1.0):
    """Box voting (reference ``boxes.py:280-329``), batched over rows as
    JAX's ``ops/boxes.box_voting`` runs per row: each kept box becomes the
    score-weighted mean of the row's valid candidates with IoU >= thresh,
    and its score is rescored by `scoring_method` (the reference's six).

    top_boxes (M, K, 4), top_scores (M, K); all_boxes (M, N, 4), all_scores
    (M, N), all_valid (M, N) bool. Returns (voted boxes (M, K, 4), scores
    (M, K))."""
    if scoring_method not in BOX_VOTING_METHODS:
        raise NotImplementedError(scoring_method)
    ious = bbox_overlaps(top_boxes, all_boxes)  # (M, K, N)
    vote = (ious >= thresh) & all_valid[:, None, :]
    zero = torch.zeros_like(ious)
    w = torch.where(vote, all_scores[:, None, :].expand_as(ious), zero)
    wsum = torch.clamp_min(w.sum(dim=2, keepdim=True), 1e-12)
    voted = torch.bmm(w, all_boxes.float()) / wsum
    cnt = torch.clamp_min(vote.sum(dim=2), 1)

    if scoring_method == "ID":
        scores = top_scores
    elif scoring_method == "AVG":
        scores = w.sum(dim=2) / cnt
    elif scoring_method == "IOU_AVG":
        iw = torch.where(vote, ious, zero)
        scores = (iw * all_scores[:, None, :]).sum(dim=2) / torch.clamp_min(iw.sum(dim=2), 1e-12)
    elif scoring_method == "GENERALIZED_AVG":
        p = torch.where(vote, all_scores[:, None, :] ** beta, zero)
        scores = (p.sum(dim=2) / cnt) ** (1.0 / beta)
    elif scoring_method == "QUASI_SUM":
        scores = w.sum(dim=2) / cnt.float() ** beta
    else:  # TEMP_AVG, reference boxes.py:301-312: each voter's score as the
        # 2-class distribution [p, 1-p], temperature-smoothed, P(class)
        # averaged; (p/pmax)**(1/beta) == exp(log(p/pmax)/beta)
        p = all_scores[:, None, :]
        q = 1.0 - p
        pm = torch.maximum(p, q)
        a = (p / pm) ** (1.0 / beta)
        b = (q / pm) ** (1.0 / beta)
        pt = (a / (a + b)).expand_as(ious)
        scores = torch.where(vote, pt, zero).sum(dim=2) / cnt
    return voted, scores


def filter_boxes_mask(boxes, min_size, scale_factor, im_height, im_width):
    """Proposal min-size / center-inside validity mask, bool (..., N)."""
    min_size = min_size * scale_factor
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    x_ctr = boxes[..., 0] + ws / 2.0
    y_ctr = boxes[..., 1] + hs / 2.0
    return (ws >= min_size) & (hs >= min_size) & (x_ctr < im_width) & (y_ctr < im_height)
