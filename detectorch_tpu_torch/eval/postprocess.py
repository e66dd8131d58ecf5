"""Detection postprocessing: per-class NMS + global top-K, batched.

Port of ``detectorch_tpu/eval/postprocess.py`` with the batch written out
(the JAX version runs per image under vmap):

  * unscale rois by im_scale, decode per-class deltas (weights 10,10,5,5),
    clip to the original image;
  * per (image, class) for classes 1..C-1, one batched NMS: scores
    > score_thresh, NMS@0.5, up to k + slack kept per class; or soft-NMS
    (``test_cfg.soft_nms``), and box voting of the kept boxes
    (``test_cfg.do_bbox_vote``);
  * global cap per image: keep everything >= the k-th largest score, so
    ties at the threshold all survive (up to ``detections_tie_slack``).

Output is a padded (B, K, ...) detection set with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from detectorch_tpu_torch.config import TestConfig
from detectorch_tpu_torch.ops import boxes as box_ops
from detectorch_tpu_torch.ops.nms import batched_nms, batched_soft_nms, topk_stable


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) fp32, original-image coords
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int64 (1..num_classes-1; 0 where invalid)
    valid: torch.Tensor    # (B, K) bool
    # (B,) bool: False iff the nms_topk_prefilter truncated a class that had
    # more above-threshold candidates than the prefilter width
    nms_exact: torch.Tensor


def decode_boxes(rois, bbox_deltas, im_scale, orig_h, orig_w, test_cfg: TestConfig):
    """rois (B, N, 4) scaled coords + deltas (B, N, 4C) -> per-class boxes
    (B, N, C, 4) in original-image coords, clipped. im_scale, orig_h and
    orig_w are (B,)."""
    boxes = rois / im_scale[:, None, None]
    pred = box_ops.bbox_transform(boxes, bbox_deltas, test_cfg.bbox_reg_weights)
    pred = box_ops.clip_boxes(pred, orig_h[:, None], orig_w[:, None])
    b, n = rois.shape[:2]
    return pred.reshape(b, n, -1, 4)


def postprocess_detections(cls_scores, bbox_deltas, rois, roi_valid, im_scale,
                           orig_h, orig_w, test_cfg: TestConfig,
                           num_classes: int = 81) -> Detections:
    """cls_scores (B, N, C) softmax probs; bbox_deltas (B, N, 4C); rois
    (B, N, 4) in network-input (scaled) coords; roi_valid (B, N) bool."""
    pred = decode_boxes(rois, bbox_deltas, im_scale, orig_h, orig_w, test_cfg)
    return postprocess_decoded(cls_scores, pred, roi_valid, test_cfg, num_classes)


def postprocess_decoded(cls_scores, pred, roi_valid, test_cfg: TestConfig,
                        num_classes: int = 81) -> Detections:
    """Threshold / NMS / cap over already-decoded per-class boxes
    pred (B, N, C, 4)."""
    k = test_cfg.detections_per_img
    # per-class NMS keeps up to k_pad: the global >= threshold cap can admit
    # more than k detections from one class when scores tie at the
    # threshold, but never more than its own k_pad slots
    k_pad = k + test_cfg.detections_tie_slack
    bsz, n = cls_scores.shape[:2]
    nc = num_classes - 1

    # drop background class 0; axes become (B, C-1, N, ...)
    cls_boxes = pred[:, :, 1:, :].permute(0, 2, 1, 3).reshape(bsz * nc, n, 4)
    cls_sc = cls_scores[:, :, 1:].permute(0, 2, 1).reshape(bsz * nc, n)
    valid = roi_valid[:, None, :].expand(bsz, nc, n).reshape(bsz * nc, n) \
        & (cls_sc > test_cfg.score_thresh)

    neg_inf = float("-inf")
    nms_exact = torch.ones(bsz, dtype=torch.bool, device=cls_scores.device)
    m = test_cfg.nms_topk_prefilter
    if test_cfg.soft_nms:
        keep_idx, keep_scores, keep_ok = batched_soft_nms(
            cls_boxes, cls_sc, k_pad, sigma=test_cfg.soft_nms_sigma,
            overlap_thresh=test_cfg.nms_thresh, score_thresh=0.0001,
            method=test_cfg.soft_nms_method, valid=valid)
    elif m and n > m:
        # per-class top-M prefilter: exact whenever every class has <= M
        # above-threshold candidates; the stable top-k keeps ties in index
        # order, so the NMS tie order is unchanged
        sv = torch.where(valid, cls_sc, torch.full_like(cls_sc, neg_inf))
        top_s, top_i = topk_stable(sv, m)
        top_b = torch.gather(cls_boxes, 1, top_i[..., None].expand(-1, -1, 4))
        keep_m, keep_ok = batched_nms(top_b, top_s, k_pad, test_cfg.nms_thresh,
                                      valid=top_s > neg_inf)
        keep_idx = torch.gather(top_i, 1, keep_m)
        keep_scores = torch.gather(cls_sc, 1, keep_idx)
        nms_exact = (valid.sum(dim=1) <= m).reshape(bsz, nc).all(dim=1)
    else:
        keep_idx, keep_ok = batched_nms(cls_boxes, cls_sc, k_pad, test_cfg.nms_thresh,
                                        valid=valid)
        keep_scores = torch.gather(cls_sc, 1, keep_idx)
    keep_boxes = torch.gather(cls_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    if test_cfg.do_bbox_vote:
        # refine the kept boxes by voting with all of the class's
        # above-threshold candidates (reference result_utils.py:152-158)
        keep_boxes, keep_scores = box_ops.box_voting(
            keep_boxes, keep_scores, cls_boxes,
            torch.where(valid, cls_sc, torch.zeros_like(cls_sc)), valid,
            test_cfg.bbox_vote_thresh, test_cfg.bbox_vote_method)
    keep_scores = torch.where(keep_ok, keep_scores, torch.full_like(keep_scores, neg_inf))

    # global cap per image: top k + slack (ties to the lower flat index =
    # class-major order), then validate by the >= k-th score rule
    flat_scores = keep_scores.reshape(bsz, nc * k_pad)
    flat_boxes = keep_boxes.reshape(bsz, nc * k_pad, 4)
    flat_cls = torch.arange(1, num_classes, device=cls_scores.device)[:, None] \
        .expand(nc, k_pad).reshape(-1)
    top_scores, top_idx = topk_stable(flat_scores, k_pad)
    n_dets = (flat_scores > neg_inf).sum(dim=1, keepdim=True)
    image_thresh = top_scores[:, k - 1: k]  # finite whenever n_dets > k
    ok = torch.where(n_dets > k, top_scores >= image_thresh, top_scores > neg_inf)
    return Detections(
        boxes=torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(ok, top_scores, torch.zeros_like(top_scores)),
        classes=torch.where(ok, flat_cls[top_idx], torch.zeros_like(top_idx)),
        valid=ok,
        nms_exact=nms_exact,
    )
